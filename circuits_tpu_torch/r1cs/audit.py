"""Residual audit: every circom `===` has a named counterpart in the port.

Port of `circuits_tpu/r1cs/audit.py`. The port, like the JAX package,
replaces R1CS checking with algebraic residuals evaluated during witness
computation (r1cs/checker.py). This module makes that claim
machine-checkable for the port's own code:

  * `parse_reference_sites()` scans the reference circuit sources
    (`REF_SRC`, the reference's src/*.circom and src/lib/*.circom) for
    every `===` statement and every `ForceEqualIfEnabled()` instantiation
    -- the complete set of application-level constraint sites;
  * `MANIFEST` maps each site to how the port discharges it, with the
    JAX package's keys and kinds in its order:
      - "residual":        a runtime ok-mask; `anchor` must literally
                           appear in `file` under circuits_tpu_torch/
                           (checked), and is text that goes if the
                           residual is deleted;
      - "composed":        subsumed by another residual through input
                           construction (e.g. the last-lane im pins are
                           folded into the expected-chain arrays);
      - "by-construction": the circom constraint pins a non-deterministic
                           hint (`<--`); the engine computes the unique
                           satisfying assignment directly, so no
                           disagreement is possible;
  * `KERNEL_ANCHORS`: where the card's route decides a residual inside a
    kernel rather than in its plain version, the kernel's source and the
    text of its verdict (checked beside the plain version's anchor; it
    adds no count);
  * `audit()` checks both directions: every parsed site appears in the
    MANIFEST, and every anchor exists in the port.

circomlib-internal constraints (Poseidon S-boxes, SMT hash chains,
EdDSA, SHA256 wiring, Num2Bits bit binarity, IsZero inverse pinning)
are all of the "by-construction" class -- the engine evaluates those
gadgets as functions -- EXCEPT the proof-validity relations, which are
runtime residuals listed in EXTRA_RESIDUALS. Of the kernels, K3
(csrc/eddsa.cu) and AySign2Ax (csrc/ay_sign.cu, Bits2Point_Strict's
on-curve flag) decide one each: K2 (csrc/smt.cu) returns the chains' roots,
and `ops/smt.py:processor_check` holds them against the old root.

`report()` prints the audit beside the analytic counting model of the
reference's tools/circuit-constraints.js:31-63 (r1cs/constraints.py),
the text of the JAX package's `report()` for the same sources.
"""

from __future__ import annotations

import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
# the reference's circom sources, read from inside the repository only
# (src/*.circom and src/lib/*.circom); the repository does not hold them
# yet, so the audit names every site dead, as the JAX audit does where its
# directory is absent
REF_SRC = REPO / "reference" / "src"

# site key -> (kind, port file, anchor substring or justification)
MANIFEST = {
    # --- balance-updater.circom ---
    "balance-updater.circom:83": (
        "residual", "circuits_tpu_torch/models/balance_updater.py",
        "fee_ok & in_range & (underflow_ok | on_chain)"),
    # --- compute-fee.circom ---
    "compute-fee.circom:70": (
        "by-construction", "circuits_tpu_torch/ops/gadgets.py",
        "bit binarity of the 253-bit hint: bits are computed by shifting"),
    "compute-fee.circom:87": (
        "residual", "circuits_tpu_torch/ops/gadgets.py",
        "ok & fits_bits(fee_not_shifted, 253)"),
    "compute-fee.circom:90": (
        "residual", "circuits_tpu_torch/ops/gadgets.py",
        "torch.where(apply_shift, ~ov_shifted"),
    "compute-fee.circom:91": (
        "residual", "circuits_tpu_torch/ops/gadgets.py",
        "~ov_shifted, ~ov_not_shifted)"),
    # --- decode-tx.circom ---
    "decode-tx.circom:124": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "ok & ~pad_from"),
    "decode-tx.circom:137": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "~pad_from & ~pad_to"),
    "decode-tx.circom:331": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "ok & ((on_chain & from_idx_zero) == new_account)"),
    "decode-tx.circom:344": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "ok & ~((~previous_on_chain) & on_chain)"),
    "decode-tx.circom:368": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "ok & (mnb_ok | mnb_zero)"),
    "decode-tx.circom:338": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "ok & (fr.eq(aux_from_idx, out_idx) | ~create)"),
    "decode-tx.circom:347": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "chain_ok = fr.eq(global_chain_id, chain_id) | on_chain"),
    "decode-tx.circom:355": (
        "residual", "circuits_tpu_torch/models/decode_tx.py",
        "const_ok = fr.eq(const_sig, fr.const(CONST_SIG, bshape, dev))"),
    # --- fee-tx.circom ---
    "fee-tx.circom:53": (
        "residual", "circuits_tpu_torch/models/fee_tx.py",
        "ok = fr.eq(fee_plan_token, token_id) | fee_idx_zero"),
    # --- hash-inputs.circom ---
    "hash-inputs.circom:61": (
        "residual", "circuits_tpu_torch/models/hash_inputs.py",
        "ok = fits_bits(old_last_idx, n_levels)"),
    "hash-inputs.circom:71": (
        "residual", "circuits_tpu_torch/models/hash_inputs.py",
        "& fits_bits(new_last_idx, n_levels)"),
    "hash-inputs.circom:98": (
        "residual", "circuits_tpu_torch/models/hash_inputs.py",
        "ok = ok & fits_bits(fee_txs_data[i], n_levels)"),
    # --- rollup-main.circom ---
    "rollup-main.circom:208": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        '(inp["im_on_chain"] <= 1).all()'),
    "rollup-main.circom:212": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        "lane_ok = lane_ok & (inp[flag] <= 1)"),
    "rollup-main.circom:213": (
        "composed", "circuits_tpu_torch/models/rollup_main.py",
        'newAccount binarity: same loop as :212 ("new_account" in the '
        'flag list)'),
    "rollup-main.circom:215": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'lane_ok = (inp["from_bjj_compressed"] <= 1).all(dim=0)'),
    "rollup-main.circom:217": (
        "composed", "circuits_tpu_torch/models/rollup_main.py",
        'isOld0_1 binarity: same loop as :212 ("is_old0_1" in the flag '
        'list)'),
    "rollup-main.circom:218": (
        "composed", "circuits_tpu_torch/models/rollup_main.py",
        'isOld0_2 binarity: same loop as :212'),
    "rollup-main.circom:259": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'lane_ok & fr.eq(dec["tx_compressed_data_v2"],'),
    "rollup-main.circom:263": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        '((inp["on_chain"].bool() == chains["im_oc_next"])'),
    "rollup-main.circom:264": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'fr.eq(dec["out_idx"], chains["expected_out_idx"])'),
    "rollup-main.circom:384": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'lane_ok & fr.eq(txo["new_state_root"],'),
    "rollup-main.circom:385": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'lane_ok & (fr.eq(txo["new_exit_root"],'),
    "rollup-main.circom:387": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        '(txo["acc_fee_out"] == chains["expected_acc_fee"]'),
    "rollup-main.circom:423": (
        "residual", "circuits_tpu_torch/models/rollup_main.py",
        'fr.eq(fee_root[:, :-1], inp["im_state_root_fee"])'),
    "rollup-main.circom:427": (
        "composed", "circuits_tpu_torch/models/rollup_main.py",
        "imInitStateRootFee is the last entry of expected_state_root "
        "(build_chains), so :384's residual covers it"),
    "rollup-main.circom:430": (
        "composed", "circuits_tpu_torch/models/rollup_main.py",
        "imFinalAccFee is the last slice of expected_acc_fee "
        "(build_chains), so :387's residual covers it"),
    # --- rollup-tx-states.circom ---
    "rollup-tx-states.circom:172": (
        "residual", "circuits_tpu_torch/models/tx_states.py",
        "ok = ~((~on_chain) & is_load_amount)"),
    "rollup-tx-states.circom:175": (
        "residual", "circuits_tpu_torch/models/tx_states.py",
        "ok = ok & ~((~on_chain) & new_account)"),
    # --- rollup-tx.circom (phase C ForceEqualIfEnabled bank) ---
    "rollup-tx.circom:237": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(~on_chain, inp["nonce"], inp["nonce1"])'),
    "rollup-tx.circom:245": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(check_to, inp["to_eth_addr"], inp["eth_addr2"])'),
    "rollup-tx.circom:253": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(st["check_to_bjj"], inp["ay2"], inp["to_bjj_ay"])'),
    "rollup-tx.circom:259": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(st["check_to_bjj"], fr.from_bool(inp["sign2"]),\n'
        '                      fr.from_bool(inp["to_bjj_sign"]))'),
    "rollup-tx.circom:266": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(~on_chain, inp["token_id"], inp["token_id1"])'),
    "rollup-tx.circom:273": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if((~on_chain) & ~st["is_p2_insert"],\n'
        '                      inp["token_id"], inp["token_id2"])'),
    "rollup-tx.circom:281": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(st["is_p1_insert"], inp["token_id"], inp["token_id1"])'),
    "rollup-tx.circom:289": (
        "residual", "circuits_tpu_torch/models/rollup_tx.py",
        '_feq_if(st["is_p1_insert"],\n                      '
        'inp["from_eth_addr"], inp["eth_addr1"])'),
    # --- rq-tx-verifier.circom ---
    "rq-tx-verifier.circom:91": (
        "residual", "circuits_tpu_torch/models/rq_tx_verifier.py",
        "fr.eq(_mux8(sel, table(future_tx_v2, past_tx_v2)), rq_tx_v2)"),
    "rq-tx-verifier.circom:92": (
        "residual", "circuits_tpu_torch/models/rq_tx_verifier.py",
        "fr.eq(_mux8(sel, table(future_to_eth, past_to_eth)), rq_to_eth)"),
    "rq-tx-verifier.circom:93": (
        "residual", "circuits_tpu_torch/models/rq_tx_verifier.py",
        "fr.eq(_mux8(sel, table(future_to_ay, past_to_ay)), rq_to_ay)"),
    # --- withdraw.circom ---
    "withdraw.circom:130": (
        "residual", "circuits_tpu_torch/models/hash_inputs.py",
        "ok = fits_bits(idx, n_levels)"),
}

# Runtime residuals that guard circomlib-internal proof relations (no
# single `===` site in the reference's own src; they live inside the
# included circomlib templates).
EXTRA_RESIDUALS = {
    "circomlib SMTProcessor old-root validity": (
        "circuits_tpu_torch/ops/smt.py",
        "ok = ~enabled | fr.eq(computed_old, old_root)"),
    "circomlib SMTProcessor top-sibling-zero (SMTLevIns)": (
        "circuits_tpu_torch/ops/smt.py",
        "(~enabled | fr.is_zero(top_sibling))"),
    "circomlib SMTVerifier root match": (
        "circuits_tpu_torch/ops/smt.py", "ok = fr.eq(child, root)"),
    "circomlib EdDSAPoseidonVerifier identity": (
        "circuits_tpu_torch/ops/babyjubjub.py",
        "return fr.eq(l1, l2) & fr.eq(l3, l4)"),
    "circomlib Bits2Point_Strict on-curve": (
        "circuits_tpu_torch/ops/babyjubjub.py", "return ax, ok & ~den_zero"),
    "circomlib Num2Bits range (decode widths)": (
        "circuits_tpu_torch/ops/gadgets.py", "def fits_bits"),
}

# MANIFEST / EXTRA_RESIDUALS key -> (kernel source, anchor): the residuals
# the card decides inside a kernel, checked beside the plain version's
KERNEL_ANCHORS = {
    "circomlib EdDSAPoseidonVerifier identity": (
        "circuits_tpu_torch/csrc/eddsa.cu",
        "ok[b] = ((eq >> gbase) & 0xfu) == 0xfu"),
    "circomlib Bits2Point_Strict on-curve": (
        "circuits_tpu_torch/csrc/ay_sign.cu",
        "ok[b] = (found || z) && !den_zero"),
}


def parse_reference_sites() -> dict[str, str]:
    """Scan the reference src for constraint sites. Returns
    {"file.circom:line": source text}. Sites = `===` statements +
    `ForceEqualIfEnabled()` instantiations."""
    sites = {}
    for f in sorted(REF_SRC.glob("*.circom")) + sorted(
            (REF_SRC / "lib").glob("*.circom")):
        rel = f.name
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if "===" in line or re.search(
                    r"=\s*ForceEqualIfEnabled\(\)", line):
                sites[f"{rel}:{i}"] = line.strip()
    return sites


def audit() -> dict:
    """Bidirectional check. Returns dict(missing_sites, dead_entries,
    bad_anchors, counts, n_sites, n_extra). All three lists must be
    empty."""
    sites = parse_reference_sites()
    missing = [k for k in sites if k not in MANIFEST]
    dead = [k for k in MANIFEST if k not in sites]
    anchors = [(key, file, anchor)
               for key, (kind, file, anchor) in MANIFEST.items()
               if kind == "residual"]
    anchors += [(name, file, anchor)
                for name, (file, anchor) in EXTRA_RESIDUALS.items()]
    anchors += [(key, file, anchor)
                for key, (file, anchor) in KERNEL_ANCHORS.items()]
    bad = [(key, file, anchor) for key, file, anchor in anchors
           if anchor not in (REPO / file).read_text()]
    counts = {}
    for key, (kind, _, _) in MANIFEST.items():
        comp = key.split(":")[0]
        counts.setdefault(comp, {"residual": 0, "composed": 0,
                                 "by-construction": 0})
        counts[comp][kind] += 1
    return dict(missing_sites=missing, dead_entries=dead,
                bad_anchors=bad, counts=counts,
                n_sites=len(sites), n_extra=len(EXTRA_RESIDUALS))


def report(n_tx=2048, n_levels=32, max_l1_tx=256, max_fee_tx=64) -> str:
    """Human-readable audit + the analytic R1CS mass for scale context
    (the analytic model counts compiled R1CS rows -- dominated by the
    circomlib gadget internals this engine evaluates by construction --
    so the two numbers measure different things by design)."""
    from . import constraints as cc

    a = audit()
    lines = [f"reference constraint sites: {a['n_sites']} "
             f"(+{a['n_extra']} circomlib proof relations)"]
    for comp, c in sorted(a["counts"].items()):
        lines.append(f"  {comp:28s} residual={c['residual']:2d} "
                     f"composed={c['composed']} "
                     f"by-construction={c['by-construction']}")
    ok = not (a["missing_sites"] or a["dead_entries"] or a["bad_anchors"])
    lines.append(f"audit: {'OK' if ok else 'FAILED'} "
                 f"missing={a['missing_sites']} dead={a['dead_entries']} "
                 f"bad_anchors={a['bad_anchors']}")
    lines.append(
        f"analytic R1CS total @({n_tx},{n_levels},{max_l1_tx},"
        f"{max_fee_tx}): {cc.total_constraints(n_tx, n_levels, max_l1_tx, max_fee_tx):,}"
        " rows (circuit-constraints.js model)")
    return "\n".join(lines)


if __name__ == "__main__":
    print(report())
