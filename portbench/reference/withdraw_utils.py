"""commonjs `withdrawUtils` equivalent — host oracle for the Withdraw
circuit's public-input hash (reference usage:
test/withdraw.test.js:150)."""

from __future__ import annotations

from .scalar import P
from .rollup_db import sha256_bitstring


def _to_int(v) -> int:
    if isinstance(v, str):
        return int(v, 16)
    return int(v)


def hash_inputs_withdraw(inp: dict) -> int:
    """SHA256 of rootExit(256) | ethAddr(160) | tokenID(32) |
    balance(192) | idx(48), reduced into Fr
    (src/withdraw.circom:84-176)."""
    bits = (format(_to_int(inp["rootExit"]) & ((1 << 256) - 1), "0256b")
            + format(_to_int(inp["ethAddr"]) & ((1 << 160) - 1), "0160b")
            + format(_to_int(inp["tokenID"]) & ((1 << 32) - 1), "032b")
            + format(_to_int(inp["balance"]) & ((1 << 192) - 1), "0192b")
            + format(_to_int(inp["idx"]) & ((1 << 48) - 1), "048b"))
    return sha256_bitstring(bits) % P
