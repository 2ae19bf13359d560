"""BalanceUpdater -- batched sender/receiver balance transition.

Port of `circuits_tpu/models/balance_updater.py` (reference:
src/balance-updater.circom:24-113).
"""

from __future__ import annotations

from ..field import fr
from ..ops.gadgets import compute_fee, fits_bits


def balance_updater(
    old_balance_sender, old_balance_receiver, amount, load_amount,
    fee_selector, on_chain, nop, nullify_load_amount, nullify_amount,
):
    """fee_selector: (B,) integers. Other field args (16, B); flags (B,).
    Returns (outputs: dict, ok: (B,) bool)."""
    bshape = amount.shape[1:]
    dev = amount.device
    on_chain = on_chain.bool()
    nop = nop.bool()
    nullify_load_amount = nullify_load_amount.bool()
    nullify_amount = nullify_amount.bool()

    apply_fee = (~on_chain) & (~nop)
    fee2_charge, fee_ok = compute_fee(fee_selector, amount, apply_fee)

    zero = fr.zeros(bshape, dev)
    eff_load1 = fr.select(on_chain, load_amount, zero)
    eff_load2 = fr.select(nullify_load_amount, zero, eff_load1)
    eff_amount1 = fr.select(nop, zero, amount)
    eff_amount2 = fr.select(nullify_amount, zero, eff_amount1)

    # underflow check: bit 192 of 2^192 + bal + load - amt - fee (:77-80)
    acc = fr.add(fr.const(1 << 192, bshape, dev).expand(amount.shape),
                 old_balance_sender)
    acc = fr.add(acc, eff_load2)
    acc = fr.sub(acc, eff_amount2)
    acc = fr.sub(acc, fee2_charge)
    in_range = fits_bits(acc, 193)
    underflow_ok = fr.bits_le(acc, 193)[192].bool() & in_range

    ok = fee_ok & in_range & (underflow_ok | on_chain)

    eff_amount3 = fr.select(underflow_ok, eff_amount2, zero)
    new_sender = fr.sub(fr.add(old_balance_sender, eff_load2),
                        fr.add(eff_amount3, fee2_charge))
    new_receiver = fr.add(old_balance_receiver, eff_amount3)

    outputs = dict(
        new_balance_sender=new_sender,
        new_balance_receiver=new_receiver,
        is_p2_nop=~fr.is_zero(eff_amount1),  # circuit name; 1 = p2 active
        fee2_charge=fee2_charge,
        is_amount_nullified=nullify_amount | ~underflow_ok,
    )
    return outputs, ok
