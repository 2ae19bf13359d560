"""The card's fixed peak, from its published numbers and the algorithms'
least operation counts; never from a rate the port measures or from a
count of the port's own instructions, so a faster kernel moves its share
and not the peak.

NVIDIA H100 SXM5 (NVIDIA's H100 data sheet and the Hopper tuning guide):
132 SMs, 1,980 MHz boost clock, 64 32-bit integer lanes an SM (16 in each
of its four partitions: integer add, logic, shift and multiply-add issue
at 64 results a clock an SM, CUDA C Programming Guide, throughput table,
compute capability 9.0), 3.35 TB/s of HBM3.

A 256-bit Montgomery product (CIOS, 8 words of 32 bits): the schoolbook
product a x b is 64 word products, each needing its low and its high half
(128 multiplies); the reduction forms each of the 8 words' quotient m_i =
t_i x n' mod 2^32 (8 low multiplies) and adds m_i x N (64 word products,
128 multiplies): 264. A square needs only the 36 distinct word products
of a x a (72 multiplies) and the same reduction: 208. Every other
instruction (the carries' adds) is left out, so the least time is a floor.

A SHA-256 block at least: a round is 6 shifts, 4 three-input logic
operations (Sigma0, Sigma1, Ch, Maj) and 4 three-input adds; a schedule
word (48 a block) 6 shifts, 2 xors and 2 adds; K + W one add: 64 x 14 +
48 x 10 + 64 = 1,440 32-bit operations.
"""

from __future__ import annotations

CARDS = {
    "NVIDIA H100 80GB HBM3": dict(sms=132, clock_hz=1.98e9,
                                  int32_lanes_per_sm=64,
                                  hbm_bytes_per_s=3.35e12),
}
MONT_MUL = 264
MONT_SQR = 208
SHA_BLOCK_OPS = 64 * 14 + 48 * 10 + 64


def card(kind: str) -> dict | None:
    """The card's published numbers, or None for a card not in the
    table (its rooflines are then not read)."""
    return CARDS.get(kind)


def least_seconds(ops: float, moved: float, kind: str):
    """(seconds, bound) the card needs at least for `ops` 32-bit integer
    operations and `moved` bytes: the larger of the two times; None for a
    card not in the table."""
    c = card(kind)
    if c is None:
        return None
    ops_s = ops / (c["sms"] * c["int32_lanes_per_sm"] * c["clock_hz"])
    bytes_s = moved / c["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
