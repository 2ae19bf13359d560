"""CLI of the PyTorch/CUDA port, verb for verb that of the JAX package
(`circuits_tpu/tools/cli.py`, after the reference's
tools/build-circuit.js and tools/generate-input.js):

  create  nTx nLevels maxL1Tx maxFeeTx   -> write circuit config dir
  compile nTx nLevels maxL1Tx maxFeeTx   -> build the kernel library,
                                            capture RollupMain as a CUDA
                                            graph, then replay it once on
                                            an example batch; print the
                                            seconds of each
  compilewitness [params]                -> alias of compile
  input   nAccounts nTransfers [nTx nLevels maxL1Tx maxFeeTx]
                                         -> generate inputs-N.json (host
                                            only, the port's builder)
  witness input.json output.json [params]-> evaluate witness, write
                                            public outputs + verdict
  witnessfull input.json out.wtns [params]-> export the full witness vector
                                            as a snarkjs .wtns container +
                                            .sym.json name sidecar, and
                                            re-verify every relation from
                                            the exported vector alone
  check   input.json [params]            -> constraint verdict only
  trace   input.json [params] [signal]   -> printSignals equivalent: the
                                            named-signal catalog (or one
                                            signal) per tx lane
  audit                                  -> r1cs residual audit report
                                            (r1cs/audit.py: the reference's
                                            circom sources against the
                                            port's residuals; no device)
  zkey / solidity                        -> out of scope (documented):
                                            Groth16 proving/verifier export
                                            stays with snarkjs

The engine verbs (compile, compilewitness, witness, witnessfull, check,
trace) run on the card, and raise where there is none, unless
`--device cpu` is given: then the plain PyTorch versions run.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def _stringify(obj):
    if isinstance(obj, bool):
        return obj
    if isinstance(obj, int):
        return str(obj)
    if isinstance(obj, list):
        return [_stringify(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _stringify(v) for k, v in obj.items()}
    return obj


def _parse(obj):
    if isinstance(obj, str) and (obj.isdigit() or
                                 (obj.startswith("-") and
                                  obj[1:].isdigit())):
        return int(obj)
    if isinstance(obj, list):
        return [_parse(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _parse(v) for k, v in obj.items()}
    return obj


def _circuit_dir(n_tx, n_levels, max_l1, max_fee) -> Path:
    return Path(f"rollup-{n_tx}-{n_levels}-{max_l1}-{max_fee}")


def _engine(params, device):
    from ..engine.witness import RollupEngine

    return RollupEngine(*params, device=device)


def _load_params(args, idx):
    if len(args) > idx:
        return tuple(map(int, args[idx:idx + 4]))
    raise SystemExit("pass nTx nLevels maxL1Tx maxFeeTx")


def example_input(n_tx, n_levels, max_l1_tx, max_fee_tx) -> dict:
    """A small valid batch at the given parameters (two L1 deposits, then
    one signed L2 transfer with a fee token): the builder input dict that
    `compile` makes its first call on."""
    from ..builder import float40
    from ..builder.account import HermezAccount
    from ..builder.rollup_db import RollupDB

    a1, a2 = HermezAccount(1), HermezAccount(2)
    db = RollupDB()
    bb = db.build_batch(n_tx, n_levels, max_l1_tx, max_fee_tx)
    for acc, amt in [(a1, 1000), (a2, 2000)]:
        bb.add_tx(dict(fromIdx=0, loadAmountF=float40.fix2float(amt),
                       tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                       fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
    bb.build()
    db.consolidate(bb)

    bb2 = db.build_batch(n_tx, n_levels, max_l1_tx, max_fee_tx)
    bb2.add_token(1)
    bb2.add_fee_idx(257)
    tx = dict(fromIdx=256, toIdx=257, tokenID=1, amount=100, userFee=126,
              nonce=0, onChain=0)
    a1.sign_tx(tx)
    bb2.add_tx(tx)
    bb2.build()
    return bb2.get_input()


def cmd_create(args, device):
    n_tx, n_levels, max_l1, max_fee = map(int, args[:4])
    if n_levels < 16:
        print("WARNING: nLevels < 16 is incompatible with firstIdx = 255 "
              "(reference tools/build-circuit.js:26-29)")
    d = _circuit_dir(n_tx, n_levels, max_l1, max_fee)
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(dict(
        nTx=n_tx, nLevels=n_levels, maxL1Tx=max_l1, maxFeeTx=max_fee)))
    print(f"created {d}")


def cmd_compile(args, device):
    """Build the kernel library and capture RollupMain as a CUDA graph
    ahead (one warm-up on zero inputs, then the capture; nothing to build
    or capture for the CPU), then one first call of RollupEngine.run on
    `example_input`, a replay on the card: the time a fresh process that
    will run many batches takes to its first witness."""
    from .. import kernels
    from ..r1cs.constraints import total_constraints

    params = tuple(map(int, args[:4]))
    eng = _engine(params, device)
    t0 = time.time()
    if eng.device.type == "cuda":
        so = kernels.build()
        kernels.prepare(eng.device)
        print(f"kernel library {so.name} ready in {time.time() - t0:.1f}s")
        t0 = time.time()
        graph = eng.compile()
        print(f"captured RollupMain({','.join(map(str, params))}) as a CUDA "
              f"graph of {graph.nodes:,} nodes in "
              f"{time.time() - t0:.1f}s (" + ", ".join(
                  f"{k} {v:.1f}s" for k, v in graph.seconds.items()) + ")")
    else:
        print(f"no kernel library on {eng.device.type}: the plain versions "
              "run")
    inp = example_input(*params)
    t0 = time.time()
    _, ok = eng.run(inp)
    if eng.device.type == "cuda":
        print(f"first replay (pack and unpack included) in "
              f"{time.time() - t0:.2f}s")
    if not ok:
        raise SystemExit("the example batch failed its constraints")
    print(f"compiled RollupMain({','.join(map(str, params))}) "
          f"in {time.time() - t0:.1f}s; "
          f"~{total_constraints(*params):,} reference constraints")


def cmd_input(args, device):
    """generate-input.js equivalent: N accounts via batched L1 deposits,
    then random transfers (tools/generate-input.js:61-109)."""
    import random as rnd
    from ..builder import float40
    from ..builder.account import HermezAccount
    from ..builder.rollup_db import RollupDB

    n_accounts = int(args[0]) if args else 32
    n_transfers = int(args[1]) if len(args) > 1 else 16
    n_tx = int(args[2]) if len(args) > 2 else 32
    n_levels = int(args[3]) if len(args) > 3 else 16
    max_l1 = int(args[4]) if len(args) > 4 else 8
    max_fee = int(args[5]) if len(args) > 5 else 64

    rnd.seed(0)
    db = RollupDB()
    accounts = [HermezAccount(i + 1) for i in range(n_accounts)]
    deposit = 10_000_000_000
    i = 0
    while i < n_accounts:
        bb = db.build_batch(n_tx, n_levels, max_l1, max_fee)
        for acc in accounts[i:i + max_l1]:
            bb.add_tx(dict(
                fromIdx=0, loadAmountF=float40.fix2float(deposit),
                tokenID=1, fromBjjCompressed=acc.bjjCompressed,
                fromEthAddr=acc.ethAddr, toIdx=0, onChain=True))
        bb.build()
        db.consolidate(bb)
        i += max_l1
    for j, acc in enumerate(accounts):
        acc.idx = 256 + j

    bb = db.build_batch(n_tx, n_levels, max_l1, max_fee)
    bb.add_token(1)
    bb.add_fee_idx(accounts[0].idx)
    nonces = {}
    for _ in range(min(n_transfers, n_tx)):
        src, dst = rnd.sample(accounts, 2)
        tx = dict(fromIdx=src.idx, toIdx=dst.idx, tokenID=1,
                  amount=float40.round_fix(rnd.randint(1, 1000) * 1000),
                  userFee=126, nonce=nonces.get(src.idx, 0), onChain=0)
        nonces[src.idx] = nonces.get(src.idx, 0) + 1
        src.sign_tx(tx)
        bb.add_tx(tx)
    bb.build()
    out = Path(f"inputs-{n_tx}.json")
    out.write_text(json.dumps(_stringify(bb.get_input())))
    print(f"wrote {out} (expected hashGlobalInputs = "
          f"{bb.get_hash_inputs()})")


def cmd_witness(args, device):
    inp = _parse(json.loads(Path(args[0]).read_text()))
    eng = _engine(_load_params(args, 2), device)
    t0 = time.time()
    out, ok = eng.run(inp)
    dt = time.time() - t0
    res = dict(ok=ok, outputs=_stringify(out),
               witnessTimeSeconds=round(dt, 3))
    Path(args[1]).write_text(json.dumps(res, indent=1))
    print(f"witness time: {dt:.3f}s  ok={ok}  "
          f"hashGlobalInputs={out['hash_global_inputs']}")


def cmd_witnessfull(args, device):
    """Export the full signal-indexed witness vector (the prover handoff
    artifact of the reference's actions.js:132-146) and prove its validity
    by re-checking every relation from the exported file alone."""
    from ..engine import witness_vector as wv
    from ..r1cs.witness_check import verify_witness

    inp = _parse(json.loads(Path(args[0]).read_text()))
    out_path = Path(args[1])
    params = _load_params(args, 2)
    eng = _engine(params, device)
    t0 = time.time()
    names, values = wv.export_witness(eng, inp)
    dt = time.time() - t0
    sym_path = out_path.with_suffix(out_path.suffix + ".sym.json")
    wv.write_wtns(out_path, values)
    wv.write_sym(sym_path, names)
    loaded = wv.load_witness(out_path, sym_path)
    res = verify_witness(loaded, *params)
    print(f"wrote {out_path} ({len(values)} signals, {dt:.3f}s) + "
          f"{sym_path.name}")
    print(f"re-verified from file: {res['n_checked']} relations, "
          f"{'ALL SATISFIED' if res['ok'] else 'FAILURES: ' + str(res['failures'][:5])}")
    sys.exit(0 if res["ok"] else 1)


def cmd_check(args, device):
    inp = _parse(json.loads(Path(args[0]).read_text()))
    _, ok = _engine(_load_params(args, 1), device).run(inp)
    print(f"constraints {'SATISFIED' if ok else 'FAILED'}")
    sys.exit(0 if ok else 1)


def cmd_trace(args, device):
    """printSignals equivalent (reference test/helpers/helpers.js:168-188):
    every cataloged internal signal, or one named signal, per lane."""
    inp = _parse(json.loads(Path(args[0]).read_text()))
    eng = _engine(_load_params(args, 1), device)
    if len(args) > 5:
        name = args[5]
        print(json.dumps({name: _stringify(eng.get_signal(inp, name))}))
        return
    print(json.dumps(_stringify(eng.trace(inp)), indent=1))


def cmd_audit(_args, _device):
    from ..r1cs.audit import report

    print(report())


def cmd_out_of_scope(verb):
    def fn(_args, _device):
        raise SystemExit(
            f"'{verb}' is out of scope by design: this framework replaces "
            "the reference's witness generation and constraint checking "
            "(layers L1-L5 + the witness-validity half of L6, SURVEY.md "
            "§1); Groth16 setup/proving and Solidity verifier export "
            "remain snarkjs's job (reference tools/helpers/"
            "actions.js:148-205) and consume this engine's witness "
            "output unchanged.")
    return fn


def _split_device(argv):
    """(argv without `--device X` / `--device=X`, the device; "cuda" when
    none is given)."""
    rest, device, i = [], "cuda", 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 == len(argv):
                raise SystemExit("--device needs a value (cuda or cpu)")
            device, i = argv[i + 1], i + 2
            continue
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return rest, device


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    argv, device = _split_device(argv)
    if not argv:
        print(__doc__)
        return
    verb, args = argv[0], argv[1:]
    fn = {"create": cmd_create, "compile": cmd_compile,
          "compilewitness": cmd_compile,
          "input": cmd_input, "witness": cmd_witness,
          "witnessfull": cmd_witnessfull,
          "check": cmd_check, "trace": cmd_trace, "audit": cmd_audit,
          "zkey": cmd_out_of_scope("zkey"),
          "solidity": cmd_out_of_scope("solidity")}.get(verb)
    if fn is None:
        raise SystemExit(f"unknown verb {verb!r}")
    fn(args, device)


if __name__ == "__main__":
    main()
