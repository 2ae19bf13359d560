"""Helpers for the tests that hold the PyTorch port against the JAX
package: the same numpy inputs go to both, results come back as numpy and
are compared exactly (all of this is integer arithmetic)."""

import numpy as np
import pytest
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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while a module runs: the plain versions'
    tensors are tiny, and more threads only cost time there. Autouse in
    each module that imports it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SUITE_CONFIG = (3, 16, 2, 2)  # (nTx, nLevels, maxL1Tx, maxFeeTx)


def suite_batches() -> dict:
    """The end-to-end suite's two batches at SUITE_CONFIG
    (tests/test_engine_e2e.py): "deposit" (two L1 account-creating
    deposits) and "l2" (an L2 transfer with a fee, an exit with a fee, one
    fee token). The builder is the port's own copy, so this also runs
    where neither JAX nor the JAX package can be imported."""
    from circuits_tpu_torch.builder import float40
    from circuits_tpu_torch.builder.account import HermezAccount
    from circuits_tpu_torch.builder.rollup_db import RollupDB
    from circuits_tpu_torch.builder.state_utils import Constants

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


RQ_CONFIG = (4, 16, 2, 2)  # two ranks of two lanes each


def rq_batches() -> dict:
    """Three batches at RQ_CONFIG whose rq-linked pair (the reference's
    test/rollup-main.test.js:619-696, after tests/test_engine_scenarios.py)
    sits on lanes 1 and 2, across the boundary of two ranks of two lanes:
    lane 0 is a transfer a3 -> a1, lane 3 a NOP, and
    "past": tx (a1 -> a2) on lane 1, tx2 (a2 -> a1, rqOffset 7, pastTx[0])
    on lane 2 -- valid, lane 2 reads lane 1;
    "switched": tx2 on lane 1, tx on lane 2 -- lane 1's link fails;
    "future": tx2 re-signed with rqOffset 1 (futureTx[0]) on lane 1, tx on
    lane 2 -- valid, lane 1 reads lane 2.
    The port's own builder, so this also runs without JAX."""
    from circuits_tpu_torch.builder import float40
    from circuits_tpu_torch.builder.account import HermezAccount
    from circuits_tpu_torch.builder.rollup_db import RollupDB
    from circuits_tpu_torch.builder.tx_utils import \
        build_tx_compressed_data_v2

    a1, a2, a3 = HermezAccount(1), HermezAccount(2), HermezAccount(3)
    db = RollupDB()
    for accounts in ((a1, a2), (a3,)):
        bb = db.build_batch(*RQ_CONFIG)
        for acc in accounts:
            bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000),
                           tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                           fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
        bb.build()
        db.consolidate(bb)
    tx0 = dict(fromIdx=258, toIdx=256, tokenID=1, amount=50, userFee=126,
               nonce=0, onChain=0)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    tx2 = dict(fromIdx=257, toIdx=256, tokenID=1, amount=100, userFee=126,
               nonce=0, onChain=0, rqOffset=7,
               rqTxCompressedDataV2=build_tx_compressed_data_v2(tx),
               rqToEthAddr=0, rqToBjjAy=0)
    tx2b = dict(tx2, rqOffset=1)
    a3.sign_tx(tx0)
    a1.sign_tx(tx)
    a2.sign_tx(tx2)
    a2.sign_tx(tx2b)
    out = {}
    for name, txs in (("past", (tx0, tx, tx2)), ("switched", (tx0, tx2, tx)),
                      ("future", (tx0, tx2b, tx))):
        bb = db.build_batch(*RQ_CONFIG)
        bb.add_token(1)
        bb.add_fee_idx(256)
        for t in txs:
            bb.add_tx(t)
        bb.build()  # the builder does not enforce rq links; the circuit does
        out[name] = bb
    return out


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


def to_bjj_batch():
    """One more batch at SUITE_CONFIG, for the residuals of a transfer to
    a BabyJubJub address (the reference's test/rollup-main.test.js:753-817):
    two deposits, a2's account made with the null eth address, then lane 0
    a transfer from a1 to a2's key (toIdx 0, toEthAddr the null address,
    toBjjAy / toBjjSign a2's), lane 1 an exit, lane 2 a NOP, one fee
    token. The port's own builder."""
    from circuits_tpu_torch.builder import float40
    from circuits_tpu_torch.builder.account import HermezAccount
    from circuits_tpu_torch.builder.rollup_db import RollupDB
    from circuits_tpu_torch.builder.state_utils import Constants

    a1, a2 = HermezAccount(1), HermezAccount(2)
    db = RollupDB()
    dep = db.build_batch(*SUITE_CONFIG)
    for acc, eth in ((a1, a1.ethAddr), (a2, Constants.nullEthAddr)):
        dep.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(1000),
                        tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                        fromEthAddr=eth, toIdx=0, onChain=True))
    dep.build()
    db.consolidate(dep)
    bb = db.build_batch(*SUITE_CONFIG)
    bb.add_token(1)
    bb.add_fee_idx(256)
    tx = dict(fromIdx=256, toIdx=Constants.nullIdx,
              toEthAddr=Constants.nullEthAddr, toBjjAy=a2.ay,
              toBjjSign=a2.sign, tokenID=1, amount=150, userFee=126,
              nonce=0, onChain=0)
    tx2 = dict(fromIdx=257, toIdx=Constants.exitIdx, tokenID=1, amount=100,
               userFee=68, nonce=0, onChain=0)
    a1.sign_tx(tx)
    a2.sign_tx(tx2)
    bb.add_tx(tx)
    bb.add_tx(tx2)
    bb.build()
    return bb


def reference_tree(root, keys):
    """A stand-in for the reference's circom sources in directory `root`:
    for each site key "file.circom:line" of `keys`, that file holds a
    `===` line at exactly that line and comment lines elsewhere; the first
    rollup-tx.circom site is a `ForceEqualIfEnabled()` instantiation
    instead, as the reference writes that bank. Returns `root`."""
    sites = {}
    for key in keys:
        name, line = key.rsplit(":", 1)
        sites.setdefault(name, set()).add(int(line))
    feq = min(sites.get("rollup-tx.circom", {0}))
    root.mkdir(parents=True, exist_ok=True)
    for name, lines in sites.items():
        text = []
        for i in range(1, max(lines) + 1):
            if i not in lines:
                text.append(f"// {name} line {i}")
            elif name == "rollup-tx.circom" and i == feq:
                text.append("    component feq = ForceEqualIfEnabled();")
            else:
                text.append(f"    a{i} === b{i};")
        (root / name).write_text("\n".join(text) + "\n")
    return root
