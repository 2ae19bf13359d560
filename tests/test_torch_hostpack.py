"""The pack's host conversion (`csrc/limbs.c` through `field/limbs.py`) on
the CPU: the port's `fr.pack_np` / `fr.unpack_np` against the JAX
package's, bit for bit, on the edge values and on every shape a pack
gives; the errors the old pack raised; the staged Withdraw pack against
the JAX engine's pack on lanes that take every path; and the counters
`pack_values` and `pack_values_slow`."""

import random
import time
import types

import numpy as np
import pytest
import torch

from circuits_tpu.field import fr as jfr
from circuits_tpu_torch import spans
from circuits_tpu_torch.engine import witness
from circuits_tpu_torch.engine.witness import (_Table, _pack,
                                               pack_withdraw_inputs)
from circuits_tpu_torch.field import fr, limbs
from circuits_tpu_torch.field.scalar import P
from circuits_tpu_torch.scripts import withdraw_cases

from torch_compare import one_thread  # noqa: F401

VALUES = {"0": 0, "1": 1, "p-1": P - 1, "p": P, "p+1": P + 1,
          "2^256-1": (1 << 256) - 1, "2^300": 1 << 300, "-1": -1,
          "-p-5": -P - 5, "hex": "0x1f", "decimal": "12345", "bool": True,
          "np.int64": np.int64(7)}


def _outcome(fn, *args):
    """fn(*args), or the type of what it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the type is the result
        return type(e)


def _same_array(got, want):
    assert not isinstance(want, type), want
    assert (got.dtype, got.shape) == (want.dtype, want.shape)
    assert np.array_equal(got, want)
    assert got.flags["C_CONTIGUOUS"]


@pytest.mark.parametrize("name", list(VALUES))
def test_pack_np_equals_jax_on_a_value(name):
    """One value alone and among plain ints: the same limbs as the JAX
    package's `pack_np`, or the same exception type where it raises (a hex
    string: `int(v)` reads no prefix), and back through `unpack_np`."""
    v = VALUES[name]
    for values in ([v], [5, v, P - 2]):
        want = _outcome(jfr.pack_np, values)
        got = _outcome(fr.pack_np, values)
        if isinstance(want, type):
            assert got is want
            continue
        _same_array(got, want)
        back = fr.unpack_np(got)
        assert list(back) == list(jfr.unpack_np(want))
        assert list(back) == [int(x) % P for x in values]


@pytest.mark.parametrize("name", list(VALUES))
def test_write_takes_the_fast_path_only_for_an_int_below_p(name):
    """`limbs.write` on one value with the Withdraw fields' reduction (a
    string read with its base prefix): the 32 bytes of that value mod P,
    and the slow path counted for every value but an int in [0, P)."""
    v = VALUES[name]
    out = np.full((1, 16), 0xAAAA, dtype="<u2")
    slow = limbs.write([v], out, 0, False, witness._based)
    want = witness._based(v)
    assert out.tobytes() == want.to_bytes(32, "little")
    assert slow == (0 if type(v) is int and 0 <= v < P else 1)
    assert limbs.read(out) == [want]


def _ragged(rng, rows, width):
    return [[rng.randrange(P) for _ in range(rng.randrange(width + 1))]
            for _ in range(rows)]


SHAPES = {
    "scalar list": lambda rng: [rng.randrange(P)],
    "1-D": lambda rng: [rng.randrange(P) for _ in range(7)],
    "2-D nested": lambda rng: [[rng.randrange(P) for _ in range(4)]
                               for _ in range(3)],
    "3-D nested": lambda rng: [[[rng.randrange(P), -1], [P, 3]]
                               for _ in range(2)],
    "empty (T = 1 imAccFeeOut)": lambda rng: [],
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pack_and_unpack_equal_jax_on_a_shape(shape):
    values = SHAPES[shape](random.Random(len(shape)))
    got, want = fr.pack_np(values), jfr.pack_np(values)
    _same_array(got, want)
    for dtype in (np.uint32, np.int64):
        a = got.astype(dtype)
        back, ref = fr.unpack_np(a), jfr.unpack_np(a)
        assert back.shape == ref.shape and back.dtype == ref.dtype
        assert back.tolist() == ref.tolist()
    # a tensor in, as the engines pass their outputs
    assert fr.unpack_np(torch.from_numpy(got.astype(np.int64))).tolist() \
        == jfr.unpack_np(want).tolist()


def test_unpack_of_one_value_and_of_a_limb_tensor():
    v = (1 << 253) + 12345
    limbs16 = jfr.pack_np([v])[:, 0]  # (16,)
    assert fr.unpack_np(limbs16).shape == () == jfr.unpack_np(limbs16).shape
    assert fr.unpack_int(torch.from_numpy(limbs16.astype(np.int64))) == v


def test_ragged_rows_padded_to_a_width_equal_the_padded_pack():
    """Rows of 0..width values, zero-filled by `limbs.write` over a buffer
    of stale limbs, against the JAX package's pack of the rows padded in
    Python; exact rows are required without `pad`."""
    rng = random.Random(9)
    width, rows = 6, _ragged(random.Random(9), 11, 6)
    out = np.full((len(rows), width, 16), 0x5A5A, dtype="<u2")
    assert limbs.write(rows, out, width, True, fr.to_field) == 0
    padded = [r + [0] * (width - len(r)) for r in rows]
    want = jfr.pack_np(padded)  # (16, rows, width)
    assert np.array_equal(np.moveaxis(out, 2, 0), want)
    with pytest.raises(ValueError, match="row"):
        limbs.write(rows, out, width, False, fr.to_field)
    long = [[rng.randrange(P) for _ in range(width + 1)]] * len(rows)
    with pytest.raises(ValueError, match="row"):
        limbs.write(long, out, width, True, fr.to_field)
    with pytest.raises(ValueError, match="rows"):
        limbs.write(rows[:-1], out, width, True, fr.to_field)


def test_empty_im_acc_fee_out_stages_to_its_shape():
    """RollupMain at T = 1 has no intermediate fee accumulators: the table
    (T - 1, F) = (0, F) stages nothing and comes out (F, 16, 0)."""
    tables = [_Table("im_acc_fee_out", "imAccFeeOut", (0, 4)),
              _Table("sign3", "sign3", (4,), convert=witness._flags)]
    src = {"imAccFeeOut": [], "sign3": [1, 0, 2, 1]}
    out = _pack(tables, src.__getitem__, torch.device("cpu"))
    assert out["im_acc_fee_out"].shape == (4, 16, 0)
    assert out["im_acc_fee_out"].dtype == torch.int64
    assert out["sign3"].tolist() == [1, 0, 2, 1]


@pytest.mark.parametrize("bad,exc", [(None, TypeError), ("zz", ValueError)])
def test_a_value_the_old_pack_rejected_still_raises(bad, exc):
    assert _outcome(jfr.pack_np, [1, bad]) is exc
    with pytest.raises(exc):
        fr.pack_np([1, bad])
    lanes = withdraw_cases.exit_tree_batch(random.Random(1), 2, 4)
    for key in ("ethAddr", "siblingsState"):
        bent = [dict(lanes[0]), lanes[1]]
        bent[0][key] = [bad] if key == "siblingsState" else bad
        with pytest.raises(exc):
            pack_withdraw_inputs(bent, 4, device="cpu")


@pytest.mark.parametrize("key", ["ay", "sign", "siblingsState"])
def test_a_lane_without_a_field_raises_key_error(key):
    lanes = withdraw_cases.exit_tree_batch(random.Random(2), 2, 4)
    bent = [lanes[0], {k: v for k, v in lanes[1].items() if k != key}]
    with pytest.raises(KeyError):
        pack_withdraw_inputs(bent, 4, device="cpu")


def _jax_withdraw_pack(inputs, n_levels):
    """The JAX engine's pack (`circuits_tpu/engine/witness.py`,
    `WithdrawEngine.run`), as the port's packed dict of numpy int64."""
    def pk(key):
        return jfr.pack_np([int(str(d[key]), 0) if isinstance(d[key], str)
                            else int(d[key]) for d in inputs])

    rows = [list(d["siblingsState"]) + [0] * (n_levels + 1 -
                                              len(d["siblingsState"]))
            for d in inputs]
    out = {name: pk(k) for k, name in witness._WITHDRAW_FIELD.items()}
    out["sign"] = np.array([int(d["sign"]) for d in inputs])
    out["siblings_state"] = np.moveaxis(jfr.pack_np(rows), 2, 0)
    return {k: v.astype(np.int64) for k, v in out.items()}


def _mixed_lanes(n_levels):
    """Withdraw lanes whose values take every path: hex and decimal
    strings, bools, numpy integers, negatives and values >= P, ragged
    siblings (one lane none at all), a sign of 2, a lane that is a
    read-only mapping."""
    lanes = withdraw_cases.exit_tree_batch(random.Random(6), 6, n_levels)
    lanes[0] = dict(lanes[0], ethAddr=hex(lanes[0]["ethAddr"]),
                    balance=str(lanes[0]["balance"]))
    lanes[1] = dict(lanes[1], tokenID=True, idx=np.int64(9), sign=2)
    lanes[2] = dict(lanes[2], ay=lanes[2]["ay"] - P,
                    rootExit=lanes[2]["rootExit"] + 3 * P,
                    siblingsState=[-1, P + 4, "7"])
    lanes[3] = dict(lanes[3], balance=1 << 300, siblingsState=[])
    lanes[4] = types.MappingProxyType(lanes[4])  # a mapping, not a dict
    return lanes


def test_staged_withdraw_pack_equals_the_jax_pack_on_every_path():
    n_levels = 8
    lanes = _mixed_lanes(n_levels)
    got = pack_withdraw_inputs(lanes, n_levels, device="cpu")
    want = _jax_withdraw_pack(lanes, n_levels)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.int64 and got[k].is_contiguous(), k
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_pack_counts_its_values_and_the_slow_ones():
    """`pack_values` counts every limb slot written (padding included) and
    `pack_values_slow` the values off the fast path: here the hex
    `ethAddr` of every other lane, as the builder and the backlog's
    traffic give it; every other value is an int in [0, P)."""
    n_levels, n = 8, 7
    lanes = withdraw_cases.exit_tree_batch(random.Random(8), n, n_levels)
    for i, d in enumerate(lanes):
        assert isinstance(d["ethAddr"], str) == (i % 2 == 1)
        fast = [v for k, v in d.items() if k not in ("sign", "ethAddr",
                                                     "siblingsState")]
        assert all(type(v) is int and 0 <= v < P
                   for v in fast + d["siblingsState"])
    t0 = time.perf_counter_ns()
    pack_withdraw_inputs(lanes, n_levels, device="cpu")
    recs = [r for r in spans.snapshot() if r["start_ns"] >= t0]
    assert [r["name"] for r in recs] == ["witness.pack"]
    assert recs[0]["counters"] == {"pack_values": n * (6 + n_levels + 1),
                                   "pack_values_slow": n // 2}
