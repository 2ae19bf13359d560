"""HermezAccount — deterministic test accounts (commonjs equivalent).

HermezAccount(i) uses the i-th ethereum private key for both the ethereum
address and (as raw bytes) the babyjubjub EdDSA key, matching the values
the reference test-suite hard-codes (e.g. HermezAccount(1).ethAddr ==
0x7e5f4552091a69125d5dfcb7b8c2659029395bdf, test/lib/hash-state.test.js:36).
"""

from __future__ import annotations

from . import babyjub as bjj
from . import tx_utils
from ..utils.crypto import eth_address
from ..field.scalar import P


class HermezAccount:
    def __init__(self, index_or_priv):
        if isinstance(index_or_priv, int):
            self.private_key = index_or_priv.to_bytes(32, "big")
        else:
            self.private_key = bytes(index_or_priv)
            assert len(self.private_key) == 32
        self.eth_priv = int.from_bytes(self.private_key, "big")
        self.ethAddr = eth_address(self.eth_priv)
        pub = bjj.prv2pub(self.private_key)
        self.ax, self.ay = pub
        packed = bjj.pack_point(pub)
        self.sign = 1 if (packed[31] & 0x80) else 0
        self.bjjCompressed = packed.hex()  # 64 hex chars, little-endian
        self.bjj_packed_int = int.from_bytes(packed, "little")
        self.idx = None  # assigned once deposited

    def sign_tx(self, tx: dict) -> None:
        tx_utils.sign_tx(tx, self.private_key)

    @property
    def eth_addr_int(self) -> int:
        return int(self.ethAddr, 16)


def bjj_compressed_to_bits(bjj_compressed) -> list[int]:
    """256 LSB-first bits of the packed point (circuit input layout,
    src/rollup-main.circom fromBjjCompressed)."""
    if isinstance(bjj_compressed, str):
        v = int.from_bytes(bytes.fromhex(bjj_compressed), "little")
    else:
        v = int(bjj_compressed)
    return [(v >> i) & 1 for i in range(256)]
