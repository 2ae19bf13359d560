"""HashInputs -- pack the pretended-public inputs and SHA-256 them.

Port of `circuits_tpu/models/hash_inputs.py` (reference:
src/hash-inputs.circom:23-185, and the Withdraw variant,
src/withdraw.circom:84-176). RollupMain's preimage, big-endian per field:
  oldLastIdx(48) | newLastIdx(48) | oldStateRoot(256) | newStateRoot(256)
  | newExitRoot(256) | L1TxsFullData | L1L2TxsData | feeTxsData
  (nLevels each) | chainID(16) | currentNumBatch(32)
"""

from __future__ import annotations

import torch

from ..field import fr
from ..ops.gadgets import fits_bits
from ..ops.sha256 import digest_to_field, sha256_bits

MAX_NLEVELS = 48  # src/hash-inputs.circom:25


def _be_bits(x, nbits):
    """Field (16, B) -> (nbits, B) MSB-first bits."""
    return torch.flip(fr.bits_le(x, nbits), dims=[0])


def hash_inputs(
    n_levels: int, n_tx: int, max_l1_tx: int, max_fee_tx: int,
    old_last_idx, new_last_idx, old_state_root, new_state_root,
    new_exit_root, l1_txs_full_data, l1l2_txs_data, fee_txs_data,
    global_chain_id, current_num_batch,
):
    """l1_txs_full_data: (maxL1Tx*736, B) bits; l1l2_txs_data:
    (nTx*(2*nLevels+48), B) bits; fee_txs_data: (maxFeeTx, 16, B) field.
    Returns (hash_out (16, B), ok (B,))."""
    ok = fits_bits(old_last_idx, n_levels) & fits_bits(new_last_idx, n_levels)
    pieces = [
        _be_bits(old_last_idx, MAX_NLEVELS),
        _be_bits(new_last_idx, MAX_NLEVELS),
        _be_bits(old_state_root, 256),
        _be_bits(new_state_root, 256),
        _be_bits(new_exit_root, 256),
        l1_txs_full_data.long(),
        l1l2_txs_data.long(),
    ]
    for i in range(max_fee_tx):
        ok = ok & fits_bits(fee_txs_data[i], n_levels)
        pieces.append(_be_bits(fee_txs_data[i], n_levels))
    pieces.append(_be_bits(global_chain_id, 16))
    pieces.append(_be_bits(current_num_batch, 32))
    digest = sha256_bits(torch.cat(pieces, dim=0))
    return digest_to_field(digest), ok


def hash_inputs_withdrawal(n_levels, root_exit, eth_addr, token_id,
                           balance, idx):
    """The Withdraw variant (src/withdraw.circom:84-176): SHA-256 of
    rootExit(256) | ethAddr(160) | tokenID(32) | balance(192) | idx(48),
    688 bits, two blocks a lane. Returns (hash_out (16, B), ok (B,))."""
    ok = fits_bits(idx, n_levels)
    preimage = torch.cat([
        _be_bits(root_exit, 256),
        _be_bits(eth_addr, 160),
        _be_bits(token_id, 32),
        _be_bits(balance, 192),
        _be_bits(idx, MAX_NLEVELS),
    ], dim=0)
    return digest_to_field(sha256_bits(preimage)), ok
