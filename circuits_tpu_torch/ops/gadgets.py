"""Small batched gadgets: float40 decode, fee computation, ranges, muxes.

Port of `circuits_tpu/ops/gadgets.py` (reference circuits:
src/lib/decode-float.circom, src/compute-fee.circom, src/lib/mux256.circom,
src/lib/utils-bjj.circom).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..field import fr
from ..builder import fee_table
from ..field import scalar

BITS_SHIFT = fee_table.BITS_SHIFT


@lru_cache(maxsize=None)
def _mont_table(kind: str, device: torch.device) -> torch.Tensor:
    """(n, 16) R-form rows: 10^e for e < 32 ("pow10"), or the adjusted fee
    factors ("fee"); one mont_mul against a canonical value applies them."""
    vals = ([pow(10, e, scalar.P) for e in range(32)] if kind == "pow10"
            else fee_table.TABLE_ADJUSTED_FEE)
    rows = [scalar.to_limbs((v * scalar.R) % scalar.P) for v in vals]
    return torch.tensor(rows, dtype=torch.int64, device=device)


def fits_bits(a: torch.Tensor, nbits: int) -> torch.Tensor:
    """(batch,) bool: a < 2^nbits (canonical input)."""
    if nbits >= 254:
        return torch.ones(a.shape[1:], dtype=torch.bool, device=a.device)
    return ~fr.geq_const(a, 1 << nbits)


def decode_float_bin(bits40: torch.Tensor) -> torch.Tensor:
    """float40 bits (40, *batch) -> value (16, *batch):
    mantissa(bits 0..34) * 10^exponent(bits 35..39)."""
    m = fr.from_bits_le(bits40[:35])
    e = (bits40[35] + 2 * bits40[36] + 4 * bits40[37] + 8 * bits40[38]
         + 16 * bits40[39]).long()
    scale_r = _mont_table("pow10", bits40.device)[e].movedim(-1, 0)
    return fr.mont_mul(m, scale_r)


def decode_float(amount_f: torch.Tensor):
    """float40 field value -> (value, ok): ok checks amountF < 2^40."""
    ok = fits_bits(amount_f, 40)
    return decode_float_bin(fr.bits_le(amount_f, 40)), ok


def compute_fee(fee_sel: torch.Tensor, amount: torch.Tensor,
                apply_fee: torch.Tensor):
    """Batched ComputeFee. fee_sel (batch,) integers 0..255; amount
    canonical (16, batch); apply_fee (batch,) bool/0-1.
    Returns (fee_out, ok); ok covers the 128-bit overflow constraints."""
    fee_sel = fee_sel.long()
    sel_eff = torch.where(apply_fee.bool(), fee_sel, 0)
    factor_r = _mont_table("fee", amount.device)[sel_eff].movedim(-1, 0)
    fee_not_shifted = fr.mont_mul(factor_r, amount)
    b6 = (fee_sel >> 6) & 1
    b7 = (fee_sel >> 7) & 1
    apply_shift = ~(b6 & b7).bool()
    bits = fr.bits_le(fee_not_shifted, 253)
    lc_shifted = fr.from_bits_le(bits[BITS_SHIFT:BITS_SHIFT + 128])
    lc_not_shifted = fr.from_bits_le(bits[:128])
    ov_shifted = bits[BITS_SHIFT + 128:253].bool().any(dim=0)
    ov_not_shifted = bits[128:253].bool().any(dim=0)
    fee_out = fr.select(apply_shift, lc_shifted, lc_not_shifted)
    ok = torch.where(apply_shift, ~ov_shifted, ~ov_not_shifted)
    return fee_out, ok & fits_bits(fee_not_shifted, 253)


def mux256(sel: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """256-way select. sel (batch,) in 0..255; table (256, 16) limb rows or
    (256, 16, *batch). Returns (16, *batch)."""
    sel = sel.long()
    if table.dim() == 2:
        return table[sel].movedim(-1, 0)
    idx = sel.reshape((1, 1) + tuple(sel.shape)).expand(
        (table.shape[1], 1) + tuple(sel.shape))
    return torch.gather(table.movedim(1, 0), 1, idx)[:, 0]


def bits_compressed_to_ay_sign(bjj_bits: torch.Tensor):
    """BitsCompressed2AySign: packed point bits (256, *batch) ->
    (ay (16, *batch), sign (*batch,) bool). No on-curve check."""
    return fr.from_bits_le(bjj_bits[:254]), bjj_bits[255].bool()
