"""RollupTxStates -- the tx-type decision table, batched over lanes.

Port of `circuits_tpu/models/tx_states.py` (reference:
src/rollup-tx-states.circom:39-314).
"""

from __future__ import annotations

from ..field import fr

ETH_ADDR_ANY = (1 << 160) - 1  # src/rollup-tx-states.circom:131
EXIT_IDX = 1                   # src/rollup-tx-states.circom:141


def rollup_tx_states(
    from_idx, to_idx, to_eth_addr, aux_from_idx, aux_to_idx,
    amount, new_exit, load_amount, new_account, on_chain,
    from_eth_addr, eth_addr1, token_id, token_id1, token_id2,
):
    """Returns (outputs: dict, ok: (B,) bool); ok covers
    (1-onChain)*isLoadAmount === 0 and (1-onChain)*newAccount === 0."""
    bshape = from_idx.shape[1:]
    dev = from_idx.device
    on_chain = on_chain.bool()
    new_account = new_account.bool()
    new_exit = new_exit.bool()
    zero = fr.zeros(bshape, dev)

    sel_aux_from = on_chain & new_account
    final_from_idx = fr.select(sel_aux_from, aux_from_idx, from_idx)

    to_idx_zero = fr.is_zero(to_idx)
    select_aux_to_idx = (~on_chain) & to_idx_zero
    final_to_idx = fr.select(select_aux_to_idx, aux_to_idx, to_idx)

    is_to_eth_addr_any = fr.eq(to_eth_addr,
                               fr.const(ETH_ADDR_ANY, bshape, dev))
    is_exit = fr.eq(final_to_idx, fr.const(EXIT_IDX, bshape, dev))

    final_from_zero = fr.is_zero(final_from_idx)
    is_final_from_idx = ~final_from_zero

    is_load_amount = ~fr.is_zero(load_amount)
    is_amount = ~fr.is_zero(amount)

    ok = ~((~on_chain) & is_load_amount)
    ok = ok & ~((~on_chain) & new_account)

    is_p1_insert = on_chain & new_account
    p1_fnc0 = is_p1_insert & is_final_from_idx
    p1_fnc1 = (~is_p1_insert) & is_final_from_idx
    key1 = fr.select(p1_fnc0 | p1_fnc1, final_from_idx, zero)

    is_p2_insert = is_exit & new_exit
    p2_fnc0 = is_p2_insert & is_final_from_idx
    p2_fnc1 = (~is_p2_insert) & is_final_from_idx
    key2 = fr.select(is_exit, fr.select(is_amount, final_from_idx, zero),
                     fr.select(is_amount, final_to_idx, zero))

    verify_sign_enabled = (~on_chain) & is_final_from_idx
    nop = final_from_zero

    tmp_check_to_eth = (~is_to_eth_addr_any) & select_aux_to_idx
    tmp_check_to_bjj = is_to_eth_addr_any & select_aux_to_idx
    check_to_eth_addr = tmp_check_to_eth & ~nop
    check_to_bjj = tmp_check_to_bjj & ~nop

    on_chain_not_create = (~new_account) & on_chain
    should_check_eth = on_chain_not_create & is_amount
    apply_null_eth = should_check_eth & ~fr.eq(from_eth_addr, eth_addr1)
    apply_null_tok1 = on_chain_not_create & ~fr.eq(token_id, token_id1)
    should_check_tok2 = on_chain & is_amount & ~is_p2_insert
    apply_null_tok2 = should_check_tok2 & ~fr.eq(token_id, token_id2)

    nullify_load_amount = apply_null_tok1 & is_load_amount
    apply_tok1_to_amount = apply_null_tok1 & is_amount
    nullify_amount = apply_null_eth | apply_null_tok2 | apply_tok1_to_amount

    outputs = dict(
        is_p1_insert=is_p1_insert,
        is_p2_insert=is_p2_insert,
        key1=key1,
        key2=key2,
        p1_fnc0=p1_fnc0,
        p1_fnc1=p1_fnc1,
        p2_fnc0=p2_fnc0,
        p2_fnc1=p2_fnc1,
        is_exit=is_exit,
        verify_sign_enabled=verify_sign_enabled,
        nop=nop,
        check_to_eth_addr=check_to_eth_addr,
        check_to_bjj=check_to_bjj,
        nullify_load_amount=nullify_load_amount,
        nullify_amount=nullify_amount,
        final_from_idx=final_from_idx,
        final_to_idx=final_to_idx,
        is_amount=is_amount,
    )
    return outputs, ok
