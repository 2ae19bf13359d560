// The host side of the pack: Python ints to field limbs and back.
//
// A CPython extension (no PyTorch headers), built at first use by
// circuits_tpu_torch/field/limbs.py with the host C compiler. A value of
// the field is 32 little-endian bytes: the 16 uint16 limbs of field/fr.py,
// limb 0 first.
//
//   modulus(p)                        P as 32 little-endian bytes; once,
//                                     before any write
//   write(values, out, width, pad, read) -> values that took `read`
//   read(raw) -> list of ints, one per 32 bytes of `raw`
//
// write: `out` is a writable C-contiguous buffer of 32 bytes a value
// slot, and its length says how much must come. With width 0, `values` is
// a sequence of values, one a slot. With width > 0 it is a sequence of
// rows, `width` slots each; a row holds exactly `width` values, or with
// `pad` at most that many, and the slots past its end are zero-filled.
// An int (exactly int, not a subclass) in [0, P) is written as it is: the
// fast path, which reads the int's digits (CPython 3.12's layout of an
// int, `long_value`) into four 64-bit words and compares them with P. Any
// other value -- negative, >= P, a bool, a numpy integer, a string -- is
// passed to read(v), which returns the int in [0, P) to write; its
// exceptions pass through. The sequences are read in place; a value is
// held while `read` runs, and a sequence that `read` resized is refused.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#if PY_VERSION_HEX < 0x030C0000
#error "limbs.c reads the int layout of CPython 3.12 or later"
#endif

#define VALUE_BYTES 32
#define WORDS 4
#define PREFETCH 8
// the digits that can hold a value below 2^256
#define MAX_DIGITS ((256 + PyLong_SHIFT - 1) / PyLong_SHIFT)

static uint64_t P_WORDS[WORDS];
static int p_set = 0;

// v (an int) as four little-endian 64-bit words; -1 where it is negative
// or needs more than 256 bits. No exception is set.
static int to_words(PyObject *v, uint64_t w[WORDS]) {
    const PyLongObject *o = (const PyLongObject *)v;
    uintptr_t tag = o->long_value.lv_tag;
    if ((tag & 3) == 2) return -1;  // the sign bits: 2 is negative
    Py_ssize_t nd = (Py_ssize_t)(tag >> 3);
    if (nd > MAX_DIGITS) return -1;  // the top digit is never 0
    memset(w, 0, WORDS * sizeof(uint64_t));
    for (Py_ssize_t i = 0; i < nd; ++i) {
        uint64_t d = o->long_value.ob_digit[i];
        Py_ssize_t bit = i * PyLong_SHIFT, k = bit >> 6;
        int s = (int)(bit & 63);
        w[k] |= d << s;
        if (s + PyLong_SHIFT > 64) {
            uint64_t hi = d >> (64 - s);
            if (k + 1 < WORDS)
                w[k + 1] |= hi;
            else if (hi)
                return -1;
        }
    }
    return 0;
}

static int below_p(const uint64_t w[WORDS]) {
    for (int i = WORDS - 1; i >= 0; --i)
        if (w[i] != P_WORDS[i]) return w[i] < P_WORDS[i];
    return 0;
}

static void store(const uint64_t w[WORDS], unsigned char *dst) {
#if PY_LITTLE_ENDIAN
    memcpy(dst, w, VALUE_BYTES);
#else
    for (int i = 0; i < VALUE_BYTES; ++i)
        dst[i] = (unsigned char)(w[i >> 3] >> (8 * (i & 7)));
#endif
}

// One value into dst; *slow counts those that took `read`.
static int put(PyObject *v, unsigned char *dst, PyObject *read,
               Py_ssize_t *slow) {
    uint64_t w[WORDS];
    if (PyLong_CheckExact(v) && to_words(v, w) == 0 && below_p(w)) {
        store(w, dst);
        return 0;
    }
    Py_INCREF(v);  // held while `read` runs
    PyObject *r = PyObject_CallOneArg(read, v);
    Py_DECREF(v);
    if (r == NULL) return -1;
    int ok = PyLong_Check(r) && to_words(r, w) == 0 && below_p(w);
    Py_DECREF(r);
    if (!ok) {
        PyErr_SetString(PyExc_ValueError,
                        "write: read() must return an int in [0, P)");
        return -1;
    }
    store(w, dst);
    ++*slow;
    return 0;
}

// Every value of the sequence `seq` (PySequence_Fast) into dst. The ints
// of a pack lie all over the heap, so the one PREFETCH items ahead is
// fetched into the cache while this one is converted.
static int put_all(PyObject *seq, Py_ssize_t n, unsigned char *dst,
                   PyObject *read, Py_ssize_t *slow) {
    for (Py_ssize_t i = 0; i < n; ++i) {
        if (i + PREFETCH < n) {
            // the object's header and its digits, which may start a line
            const char *ahead = (const char *)PySequence_Fast_GET_ITEM(
                seq, i + PREFETCH);
            __builtin_prefetch(ahead);
            __builtin_prefetch(ahead + 59);
        }
        if (put(PySequence_Fast_GET_ITEM(seq, i), dst + i * VALUE_BYTES, read,
                slow) < 0)
            return -1;
        if (PySequence_Fast_GET_SIZE(seq) != n) {
            PyErr_SetString(PyExc_RuntimeError,
                             "write: read() resized the values");
            return -1;
        }
    }
    return 0;
}

static PyObject *limbs_write(PyObject *Py_UNUSED(self), PyObject *args) {
    PyObject *values, *out, *read, *seq = NULL, *row = NULL;
    Py_ssize_t width, slow = 0;
    int pad;
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "OOnpO:write", &values, &out, &width, &pad,
                          &read))
        return NULL;
    if (!p_set) {
        PyErr_SetString(PyExc_RuntimeError, "write: modulus() not called");
        return NULL;
    }
    if (PyObject_GetBuffer(out, &view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS) <
        0)
        return NULL;
    unsigned char *base = (unsigned char *)view.buf;
    Py_ssize_t slots = view.len / VALUE_BYTES;
    if (view.len % VALUE_BYTES || width < 0 || (width && slots % width)) {
        PyErr_Format(PyExc_ValueError,
                     "write: %zd bytes are no whole number of rows of %zd "
                     "values",
                     view.len, width);
        goto fail;
    }
    seq = PySequence_Fast(values, "write: values must be a sequence");
    if (seq == NULL) goto fail;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    Py_ssize_t want = width ? slots / width : slots;
    if (n != want) {
        PyErr_Format(PyExc_ValueError, "write: %zd %s, expected %zd", n,
                     width ? "rows" : "values", want);
        goto fail;
    }
    if (width == 0) {
        if (put_all(seq, n, base, read, &slow) < 0) goto fail;
    } else {
        for (Py_ssize_t r = 0; r < n; ++r) {
            if (PySequence_Fast_GET_SIZE(seq) != n) {
                PyErr_SetString(PyExc_RuntimeError,
                                "write: read() resized the rows");
                goto fail;
            }
            row = PySequence_Fast(PySequence_Fast_GET_ITEM(seq, r),
                                  "write: a row must be a sequence");
            if (row == NULL) goto fail;
            Py_ssize_t m = PySequence_Fast_GET_SIZE(row);
            if (m > width || (!pad && m != width)) {
                PyErr_Format(PyExc_ValueError,
                             "write: row %zd holds %zd values, expected %s%zd",
                             r, m, pad ? "at most " : "", width);
                goto fail;
            }
            unsigned char *dst = base + r * width * VALUE_BYTES;
            if (put_all(row, m, dst, read, &slow) < 0) goto fail;
            memset(dst + m * VALUE_BYTES, 0, (size_t)(width - m) * VALUE_BYTES);
            Py_CLEAR(row);
        }
    }
    Py_DECREF(seq);
    PyBuffer_Release(&view);
    return PyLong_FromSsize_t(slow);
fail:
    Py_XDECREF(row);
    Py_XDECREF(seq);
    PyBuffer_Release(&view);
    return NULL;
}

static PyObject *limbs_read(PyObject *Py_UNUSED(self), PyObject *raw) {
    Py_buffer view;
    if (PyObject_GetBuffer(raw, &view, PyBUF_C_CONTIGUOUS) < 0) return NULL;
    if (view.len % VALUE_BYTES) {
        PyErr_Format(PyExc_ValueError, "read: %zd bytes are no whole number "
                     "of 32-byte values", view.len);
        PyBuffer_Release(&view);
        return NULL;
    }
    Py_ssize_t n = view.len / VALUE_BYTES;
    const unsigned char *src = (const unsigned char *)view.buf;
    PyObject *list = PyList_New(n);
    if (list != NULL) {
        for (Py_ssize_t i = 0; i < n; ++i) {
#if PY_VERSION_HEX >= 0x030D0000
            PyObject *v = PyLong_FromUnsignedNativeBytes(
                src + i * VALUE_BYTES, VALUE_BYTES,
                Py_ASNATIVEBYTES_LITTLE_ENDIAN);
#else
            PyObject *v = _PyLong_FromByteArray(src + i * VALUE_BYTES,
                                                VALUE_BYTES, 1, 0);
#endif
            if (v == NULL) {
                Py_CLEAR(list);
                break;
            }
            PyList_SET_ITEM(list, i, v);
        }
    }
    PyBuffer_Release(&view);
    return list;
}

static PyObject *limbs_modulus(PyObject *Py_UNUSED(self), PyObject *args) {
    const unsigned char *p;
    Py_ssize_t len;
    if (!PyArg_ParseTuple(args, "y#:modulus", &p, &len)) return NULL;
    if (len != VALUE_BYTES) {
        PyErr_SetString(PyExc_ValueError, "modulus: P must be 32 bytes");
        return NULL;
    }
    for (int i = 0; i < WORDS; ++i) {
        P_WORDS[i] = 0;
        for (int b = 7; b >= 0; --b) P_WORDS[i] = P_WORDS[i] << 8 | p[8 * i + b];
    }
    p_set = 1;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"write", limbs_write, METH_VARARGS,
     "write(values, out, width, pad, read) -> values that took read"},
    {"read", limbs_read, METH_O, "read(raw) -> list of ints, 32 bytes each"},
    {"modulus", limbs_modulus, METH_VARARGS, "modulus(p): P, 32 bytes LE"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {PyModuleDef_HEAD_INIT, "_ctpu_limbs",
                                    NULL, -1, methods};

PyMODINIT_FUNC PyInit__ctpu_limbs(void) { return PyModule_Create(&module); }
