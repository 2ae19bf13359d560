"""The port's SMT processor (K2's plain version on the CPU) against the JAX
package's `processor` and the host tree, on INSERT (with push-down),
UPDATE, DELETE, NOP and isOld0 lanes, plus a bad proof. Exact."""

import random

import jax
import numpy as np
import pytest
import torch

from circuits_tpu.builder.smt import SMT
from circuits_tpu.field import fr as jfr
from circuits_tpu.field.scalar import P
from circuits_tpu.ops import smt as jsmt
from circuits_tpu_torch.field import fr
from circuits_tpu_torch.ops import smt

from torch_compare import assert_same, to_torch

NL = 9


def _pad(s):
    return s + [0] * (NL - len(s))


def _args(ops):
    return dict(
        old_root=jfr.pack_np([o["old_root"] for o in ops]),
        siblings=np.moveaxis(jfr.pack_np([_pad(o["siblings"]) for o in ops]),
                             2, 0),
        old_key=jfr.pack_np([o["old_key"] for o in ops]),
        old_value=jfr.pack_np([o["old_value"] for o in ops]),
        is_old0=np.array([int(o["is_old0"]) for o in ops], np.uint32),
        new_key=jfr.pack_np([o["new_key"] for o in ops]),
        new_value=jfr.pack_np([o["new_value"] for o in ops]),
        fnc0=np.array([o["fnc"][0] for o in ops], np.uint32),
        fnc1=np.array([o["fnc"][1] for o in ops], np.uint32),
    )


def _ops():
    rng = random.Random(555)
    t = SMT()
    ops = []
    # INSERT: the first into an empty tree (isOld0), then push-downs
    for k in (1, 5, 3, 2, 9, 12, 30, 17, 100, 64):
        pr = t.insert(k, k * 1000 + 7)
        pr["fnc"] = (1, 0)
        ops.append(pr)
    for k in (5, 30, 64):
        pr = t.update(k, rng.randrange(P))
        pr["fnc"] = (0, 1)
        ops.append(pr)
    for k in (2, 100, 9):
        pr = t.delete(k)
        pr["fnc"] = (1, 1)
        pr["new_key"] = pr.pop("del_key")
        pr["new_value"] = pr.pop("del_value")
        ops.append(pr)
    ops.append(dict(old_root=t.root, siblings=[123] + [0] * (NL - 1),
                    old_key=99, old_value=98, is_old0=False, new_key=97,
                    new_value=96, fnc=(0, 0), new_root=t.root))
    bad = dict(ops[4])
    bad["old_root"] = (bad["old_root"] + 1) % P
    ops.append(bad)
    return ops


@pytest.fixture(scope="module")
def cases():
    ops = _ops()
    args = _args(ops)
    want = jax.jit(jsmt.processor)(**args)
    got = smt.processor(**{k: to_torch(v) for k, v in args.items()})
    return ops, got, want


def test_processor_matches_jax(cases):
    _, got, want = cases
    assert_same(got[0], want[0], "new_root")
    assert_same(got[1], want[1], "ok")


@pytest.mark.parametrize("kind", ["insert", "update", "delete", "nop"])
def test_processor_matches_host_tree(cases, kind):
    ops, got, _ = cases
    sel = {"insert": range(0, 10), "update": range(10, 13),
           "delete": range(13, 16), "nop": range(16, 17)}[kind]
    roots = [int(v) for v in fr.unpack_np(got[0])]
    for i in sel:
        assert bool(got[1][i]), (kind, i)
        assert roots[i] == ops[i]["new_root"], (kind, i)


def test_bad_proof_flags_and_first_insert_is_old0(cases):
    ops, got, _ = cases
    assert ops[0]["is_old0"]
    assert not bool(got[1][-1])


def test_chain_plain_equals_wrapper_on_cpu(cases):
    ops = cases[0]
    args = {k: to_torch(v) for k, v in _args(ops).items()}
    del args["old_root"]
    cargs = smt.chain_args(**args)
    assert_same(smt.processor_chain(*cargs),
                smt.processor_chain_plain(*cargs))


def test_wrapper_refuses_other_devices():
    meta = dict(dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        smt.processor_chain(torch.zeros((3, 16, 2), **meta),
                            torch.zeros((3, 2), **meta),
                            torch.zeros((3, 5, 2), **meta),
                            *(torch.zeros((16, 2), **meta),) * 3)
