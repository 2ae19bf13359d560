"""Transaction field encodings (commonjs `txUtils` equivalent).

Bit layouts are those DecodeTx unpacks
(the reference's src/decode-tx.circom:79-87,176-212,275-283).
"""

from __future__ import annotations

from . import float40
from .babyjub import sign_poseidon

# Hard-coded L2 signature constant (src/decode-tx.circom:356)
CONST_SIG = 3322668559


def build_tx_compressed_data(tx: dict) -> int:
    """constSig(32) | chainID(16) | fromIdx(48) | toIdx(48) | tokenID(32)
    | nonce(40) | userFee(8) | toBjjSign(1)"""
    res = CONST_SIG
    res |= (tx.get("chainID", 0) & ((1 << 16) - 1)) << 32
    res |= (tx.get("fromIdx", 0) & ((1 << 48) - 1)) << 48
    res |= (tx.get("toIdx", 0) & ((1 << 48) - 1)) << 96
    res |= (tx.get("tokenID", 0) & ((1 << 32) - 1)) << 144
    res |= (tx.get("nonce", 0) & ((1 << 40) - 1)) << 176
    res |= (tx.get("userFee", 0) & ((1 << 8) - 1)) << 216
    res |= (1 if tx.get("toBjjSign", False) else 0) << 224
    return res


def decode_tx_compressed_data(v: int) -> dict:
    return {
        "constSig": v & ((1 << 32) - 1),
        "chainID": (v >> 32) & ((1 << 16) - 1),
        "fromIdx": (v >> 48) & ((1 << 48) - 1),
        "toIdx": (v >> 96) & ((1 << 48) - 1),
        "tokenID": (v >> 144) & ((1 << 32) - 1),
        "nonce": (v >> 176) & ((1 << 40) - 1),
        "userFee": (v >> 216) & ((1 << 8) - 1),
        "toBjjSign": bool((v >> 224) & 1),
    }


def build_tx_compressed_data_v2(tx: dict) -> int:
    """fromIdx(48) | toIdx(48) | amountF(40) | tokenID(32) | nonce(40)
    | userFee(8) | toBjjSign(1)  (zeroed for L1 txs by DecodeTx)"""
    amount_f = float40.fix2float(tx.get("amount", 0))
    res = tx.get("fromIdx", 0) & ((1 << 48) - 1)
    res |= (tx.get("toIdx", 0) & ((1 << 48) - 1)) << 48
    res |= (amount_f & ((1 << 40) - 1)) << 96
    res |= (tx.get("tokenID", 0) & ((1 << 32) - 1)) << 136
    res |= (tx.get("nonce", 0) & ((1 << 40) - 1)) << 168
    res |= (tx.get("userFee", 0) & ((1 << 8) - 1)) << 208
    res |= (1 if tx.get("toBjjSign", False) else 0) << 216
    return res


def build_element_1(tx: dict) -> int:
    """Second sigL2Hash input: toEthAddr(160) | amountF(40) | maxNumBatch(32)
    (src/decode-tx.circom:250-273)."""
    amount_f = float40.fix2float(tx.get("amount", 0))
    res = _addr_int(tx.get("toEthAddr", 0)) & ((1 << 160) - 1)
    res |= (amount_f & ((1 << 40) - 1)) << 160
    res |= (tx.get("maxNumBatch", 0) & ((1 << 32) - 1)) << 200
    return res


def _addr_int(addr) -> int:
    if isinstance(addr, str):
        return int(addr, 16)
    return int(addr)


def build_hash_sig(tx: dict) -> int:
    """sigL2Hash = Poseidon(6)(txCompressedData, element1, toBjjAy,
    rqTxCompressedDataV2, rqToEthAddr, rqToBjjAy)
    (src/decode-tx.circom:275-283)."""
    from .poseidon_constants import poseidon_py

    return poseidon_py([
        build_tx_compressed_data(tx),
        build_element_1(tx),
        _addr_int(tx.get("toBjjAy", 0)),
        tx.get("rqTxCompressedDataV2", 0),
        _addr_int(tx.get("rqToEthAddr", 0)),
        _addr_int(tx.get("rqToBjjAy", 0)),
    ])


def sign_tx(tx: dict, prv: bytes) -> None:
    """Signs tx in place (sets s, r8x, r8y) — HermezAccount.signTx."""
    h = build_hash_sig(tx)
    sig = sign_poseidon(prv, h)
    tx["s"] = sig["S"]
    tx["r8x"] = sig["R8"][0]
    tx["r8y"] = sig["R8"][1]


# ---------------------------------------------------------------------------
# Data-availability encoders (commonjs txUtils.encodeL1Tx / encodeL2Tx /
# encodeL1TxFull; bit layouts from src/decode-tx.circom:214-247,285-324).
# All return big-endian hex strings like the reference.
# ---------------------------------------------------------------------------


def _hex_bits(value: int, nbits: int) -> str:
    return format(value & ((1 << nbits) - 1), f"0{nbits}b")


def encode_l2_tx(tx: dict, n_levels: int) -> str:
    """L1L2TxData of an L2 tx: fromIdx(nL) | finalToIdx(nL) | amountF(40)
    | userFee(8)."""
    amount_f = float40.fix2float(tx.get("amount", 0))
    to_idx = tx.get("toIdx", 0) or tx.get("auxToIdx", 0)
    bits = (_hex_bits(tx.get("fromIdx", 0), n_levels)
            + _hex_bits(to_idx, n_levels)
            + _hex_bits(amount_f, 40)
            + _hex_bits(tx.get("userFee", 0), 8))
    return format(int(bits, 2), f"0{(len(bits) + 3) // 4}x")


def encode_l1_tx(tx: dict, n_levels: int) -> str:
    """L1L2TxData of an L1 tx: fee bits zeroed; amountF encodes the
    effective (possibly nullified) amount."""
    eff = tx.get("effectiveAmount", tx.get("amount", 0))
    amount_f = float40.fix2float(eff)
    bits = (_hex_bits(tx.get("fromIdx", 0), n_levels)
            + _hex_bits(tx.get("toIdx", 0), n_levels)
            + _hex_bits(amount_f, 40)
            + _hex_bits(0, 8))
    return format(int(bits, 2), f"0{(len(bits) + 3) // 4}x")


def encode_l1_tx_full(tx: dict, n_levels: int = 0) -> str:
    """L1TxFullData (624 bits): fromEthAddr(160) | fromBjjCompressed(256)
    | fromIdx(48) | loadAmountF(40) | amountF(40) | tokenID(32) |
    toIdx(48)."""
    amount_f = float40.fix2float(tx.get("amount", 0))
    bjj = tx.get("fromBjjCompressed", 0)
    if isinstance(bjj, str):
        bjj = int.from_bytes(bytes.fromhex(bjj), "little")
    bits = (_hex_bits(_addr_int(tx.get("fromEthAddr", 0)), 160)
            + _hex_bits(int(bjj), 256)
            + _hex_bits(tx.get("fromIdx", 0), 48)
            + _hex_bits(tx.get("loadAmountF", 0), 40)
            + _hex_bits(amount_f, 40)
            + _hex_bits(tx.get("tokenID", 0), 32)
            + _hex_bits(tx.get("toIdx", 0), 48))
    return format(int(bits, 2), "0156x")
