"""FeeAccumulator -- first-match scatter-add of a tx fee into fee slots.

Port of `circuits_tpu/models/fee_accumulator.py` (reference:
src/fee-accumulator.circom:56-91).
"""

from __future__ import annotations

import torch

from ..field import fr


def fee_accumulator(token_id, fee2_charge, fee_plan_token_id, acc_fee_in):
    """token_id, fee2_charge: (16, B). fee_plan_token_id, acc_fee_in:
    (F, 16, B). Returns acc_fee_out (F, 16, B)."""
    matches = (token_id.unsqueeze(0) == fee_plan_token_id).all(dim=1)  # (F,B)
    earlier = torch.cumsum(matches.long(), dim=0) - matches.long()
    first_match = matches & (earlier == 0)
    # acc_fee_in[i] + fee2_charge for every slot i, as one field add
    added = fr.add(acc_fee_in.movedim(0, 1),
                   fee2_charge.unsqueeze(1)).movedim(1, 0)
    return torch.where(first_match.unsqueeze(1), added, acc_fee_in)
