"""Helpers for the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go to both, results come back as numpy and
are compared exactly (all of this is integer arithmetic)."""

import numpy as np
import torch


def to_torch(a) -> torch.Tensor:
    """numpy / jax array (uint32 limbs, bits or flags) -> int64 tensor."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def to_np(x) -> np.ndarray:
    """Tensor or array -> numpy int64 (bool stays bool)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x if x.dtype == np.bool_ else x.astype(np.int64)


SUITE_CONFIG = (3, 16, 2, 2)  # (nTx, nLevels, maxL1Tx, maxFeeTx)


def suite_batches() -> dict:
    """The end-to-end suite's two batches at SUITE_CONFIG
    (tests/test_engine_e2e.py): "deposit" (two L1 account-creating
    deposits) and "l2" (an L2 transfer with a fee, an exit with a fee, one
    fee token). The builder is reached through the port's jax-free door,
    so this also runs where JAX cannot be imported."""
    from circuits_tpu_torch.host import (Constants, HermezAccount, RollupDB,
                                         float40)

    a1, a2 = HermezAccount(1), HermezAccount(2)
    db = RollupDB()
    dep = db.build_batch(*SUITE_CONFIG)
    for acc in (a1, a2):
        dep.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000),
                        tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                        fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    dep.build()
    db.consolidate(dep)
    l2 = db.build_batch(*SUITE_CONFIG)
    l2.add_token(1)
    l2.add_fee_idx(256)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    tx2 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1, amount=100,
               userFee=68, nonce=0, onChain=0)
    a2.sign_tx(tx2)
    l2.add_tx(tx)
    l2.add_tx(tx2)
    l2.build()
    return {"deposit": dep, "l2": l2}


def oracle_outputs(bb) -> dict:
    """The builder's public outputs of a batch, keyed as RollupEngine.run
    returns them."""
    return dict(hash_global_inputs=bb.get_hash_inputs(),
                new_state_root=bb.get_new_state_root(),
                new_exit_root=bb.get_new_exit_root(),
                new_last_idx=bb.get_new_last_idx())


def assert_same(got, want, what=""):
    """Exact equality of a port result and a JAX result (trees of dicts /
    tuples / arrays)."""
    if isinstance(want, dict):
        assert set(got) >= set(want), (what, sorted(set(want) - set(got)))
        for k in want:
            assert_same(got[k], want[k], f"{what}.{k}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
        return
    g, w = to_np(got), to_np(want)
    if g.dtype == np.bool_ or w.dtype == np.bool_:
        g, w = g.astype(np.int64), w.astype(np.int64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.array_equal(g, w), what
