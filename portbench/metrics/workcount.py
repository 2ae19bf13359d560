"""The circuit work of one call, counted from the inputs the benchmark made
and never from the port's calls, so a change to how the port computes it
moves no count.

The units are what the circuits need by their own definition
(hermeznetwork/circuits src/): Poseidon permutations by width t
(circomlib's Poseidon(t - 1)), EdDSA-Poseidon verifications, SHA-256
blocks. Where the need depends on the data it is counted from the inputs:
an SMT proof hashes as many levels as its leaf lies deep (the index of its
last non-zero sibling, plus one), a NOP lane needs nothing, a processor
that inserts hashes one new chain. Each count is the least the circuit
needs, never more: a port may do more (a NOP lane's hashes, all nLevels + 1
levels) and its roofline share then reads lower, not above 100 %.

RollupMain, a lane (src/rollup-tx.circom, decode-tx.circom):
  L2 tx        sigL2Hash Poseidon(6) (t = 7), the verifier's message hash
               Poseidon(5) (t = 6), one EdDSA verification
  a processor  UPDATE: two state hashes Poseidon(4) (t = 5), two leaf
  that acts    hashes Poseidon(3) (t = 4), 2 x depth level hashes
               Poseidon(2) (t = 3); INSERT: one state hash, one leaf hash
               (two where the slot held a leaf), depth level hashes
  a fee slot   with an account: one UPDATE (src/fee-tx.circom)
  the tail     SHA-256 of the HashInputs preimage (hash-inputs.circom)
Withdraw, a lane (src/withdraw.circom): one state hash (t = 5), one leaf
hash (t = 4), depth level hashes (t = 3), SHA-256 of 688 bits (2 blocks).
"""

from __future__ import annotations

from collections import Counter

from ..reference.poseidon_constants import N_ROUNDS_P

R_F = 8  # full rounds of every width
# Montgomery products of one EdDSA-Poseidon verification at least (S * B8
# == R8 + 8 * hm * A on BabyJubJub in extended twisted Edwards
# coordinates), as (squares, other products): the two 253-bit scalar
# multiplications share one chain of 253 doublings (Straus), each doubling
# 3 products and 4 squares (dbl-2008-bbjlp); one addition a 4-bit window of
# each scalar (2 x 64), 7 products each against a precomputed table point
# (madd-2008-hwcd-3); A's table of 14 points, 7 products an addition (B8's
# is fixed, so free); the projective comparison, 4 products. The square
# root that recovers A's x from its compressed form is left out.
EDDSA_SQUARES = 253 * 4
EDDSA_PRODUCTS = 253 * 3 + 2 * 64 * 7 + 14 * 7 + 4
SHA_WITHDRAW_BLOCKS = 2  # 688 bits + the 65 of the padding fit two blocks
FIELD_BYTES = 32


def poseidon_products(t: int) -> tuple[int, int]:
    """(squares, other products) of one permutation of width t in the
    sparse schedule: a full round t x^5 (two squares and a product each)
    and t^2 products of its MDS mix; a partial round one x^5 and the 2t - 1
    products of its sparse mix."""
    r_p = N_ROUNDS_P[t - 2]
    squares = 2 * (R_F * t + r_p)
    products = R_F * (t * t + t) + r_p * (2 * t)
    return squares, products


def depth(siblings) -> int:
    """Levels an SMT proof hashes: its last non-zero sibling's index + 1
    (in a compressed tree the deepest sibling of a leaf is never empty)."""
    d = 0
    for i, s in enumerate(siblings):
        if int(s):
            d = i + 1
    return d


def _update(perms: Counter, siblings) -> None:
    perms[5] += 2
    perms[4] += 2
    perms[3] += 2 * depth(siblings)


def rollup_work(inp: dict, preimage_bits: int) -> dict:
    """The work of one RollupMain batch, from its input dict and the bit
    length of its HashInputs preimage."""
    perms, eddsa = Counter(), 0
    for i in range(len(inp["fromIdx"])):
        on_chain = int(inp["onChain"][i])
        if not on_chain and int(inp["fromIdx"][i]) == 0:
            continue  # a NOP lane
        if not on_chain:
            perms[7] += 1
            perms[6] += 1
            eddsa += 1
        if int(inp["newAccount"][i]):
            perms[5] += 1
            perms[4] += 1 if int(inp["isOld0_1"][i]) else 2
            perms[3] += depth(inp["siblings1"][i])
        else:
            _update(perms, inp["siblings1"][i])
        to_idx = int(inp["toIdx"][i]) or int(inp["auxToIdx"][i])
        if to_idx == 0:
            continue  # processor 2 is a NOP (an account-creating deposit)
        if to_idx == 1 and int(inp["newExit"][i]):
            perms[5] += 1
            perms[4] += 1 if int(inp["isOld0_2"][i]) else 2
            perms[3] += depth(inp["siblings2"][i])
        else:
            _update(perms, inp["siblings2"][i])
    for j, fee_idx in enumerate(inp["feeIdxs"]):
        if int(fee_idx):
            _update(perms, inp["siblings3"][j])
    sha_blocks = (preimage_bits + 1 + 64 + 511) // 512
    return dict(permutations=dict(perms), eddsa=eddsa, sha_blocks=sha_blocks,
                sha_lanes=1)


def withdraw_work(lanes: list[dict], n_levels: int) -> dict:
    """The work of one Withdraw call over `lanes`."""
    perms = Counter()
    for lane in lanes:
        perms[5] += 1
        perms[4] += 1
        perms[3] += depth(lane["siblingsState"][:n_levels + 1])
    return dict(permutations=dict(perms), eddsa=0,
                sha_blocks=SHA_WITHDRAW_BLOCKS * len(lanes),
                sha_lanes=len(lanes))


def least_ops_and_bytes(work: dict, mont_mul: int, mont_sqr: int,
                        sha_block_ops: int) -> tuple[float, float]:
    """(32-bit integer operations, bytes) that `work` needs at least, with
    a Montgomery product costing `mont_mul` 32-bit multiplies and a square
    `mont_sqr`, a SHA-256 block `sha_block_ops` operations; the bytes read
    each input once and write each output once."""
    ops = moved = 0
    for t, n in work["permutations"].items():
        sq, pr = poseidon_products(int(t))
        ops += n * (sq * mont_sqr + pr * mont_mul)
        moved += n * (int(t) + 1) * FIELD_BYTES
    ops += work["eddsa"] * (EDDSA_SQUARES * mont_sqr
                            + EDDSA_PRODUCTS * mont_mul)
    moved += work["eddsa"] * 6 * FIELD_BYTES
    ops += work["sha_blocks"] * sha_block_ops
    moved += work["sha_blocks"] * 64 + work["sha_lanes"] * FIELD_BYTES
    return float(ops), float(moved)
