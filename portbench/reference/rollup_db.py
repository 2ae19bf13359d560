"""RollupDB + BatchBuilder — the host-side input generator.

Python equivalent of @hermeznetwork/commonjs `RollupDB`/`BatchBuilder`
(the reference's L3 layer; behavioral contract in SURVEY.md §8, exercised
at the reference's test/helpers/helpers.js and tools/generate-input.js).

`build()` applies each transaction to the account SMT exactly the way the
RollupTx circuit does (states table → balance updater → fee accumulator →
two SMT operations), collecting every circuit input array including the
im* intermediary chains that make the circuit's tx lanes batch-parallel
(src/rollup-main.circom:93-99).

This layer is deliberately sequential host code: the root chain is the
inherently serial part of witness generation; the witness engine consumes its
outputs with all lanes independent.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field as dfield

from .scalar import P
from . import float40
from . import tx_utils
from .fee_table import compute_fee
from .smt import SMT
from .state_utils import hash_state, Constants

CONST_SIG = tx_utils.CONST_SIG
L1_TX_FULL_BITS = 160 + 256 + 48 + 40 + 40 + 32 + 48


def _to_int(v) -> int:
    if v is None:
        return 0
    if isinstance(v, str):
        return int(v, 16)
    if isinstance(v, bool):
        return int(v)
    return int(v)


def _bjj_compressed_int(v) -> int:
    """Hex string (little-endian packed point) or int -> 256-bit int whose
    bit i is fromBjjCompressed[i] (LSB-first circuit layout)."""
    if isinstance(v, str):
        return int.from_bytes(bytes.fromhex(v), "little")
    return _to_int(v)


def _be_bits(value: int, nbits: int) -> str:
    return format(value & ((1 << nbits) - 1), f"0{nbits}b")


@dataclass
class AccountState:
    tokenID: int
    nonce: int
    sign: int
    balance: int
    ay: int
    ethAddr: int
    idx: int = 0

    def hash(self) -> int:
        return hash_state(self.__dict__)

    def as_dict(self) -> dict:
        return dict(tokenID=self.tokenID, nonce=self.nonce, sign=self.sign,
                    balance=self.balance, ay=self.ay, ethAddr=self.ethAddr,
                    idx=self.idx)


class RollupDB:
    """Persistent account-state DB over an SMT (SMTMemDB equivalent)."""

    def __init__(self, chain_id: int = 0):
        self.state_tree = SMT()
        self.accounts: dict[int, AccountState] = {}
        self.last_idx = Constants.firstIdx
        self.chain_id = chain_id
        self.last_batch = 0
        # per-batch exit data: batch_num -> (SMT, {idx: AccountState})
        self.exit_trees: dict[int, tuple[SMT, dict]] = {}

    def build_batch(self, max_n_tx, n_levels, max_l1_tx, max_fee_tx):
        return BatchBuilder(self, max_n_tx, n_levels, max_l1_tx, max_fee_tx)

    def consolidate(self, bb: "BatchBuilder"):
        assert bb.built, "build() must run before consolidate()"
        self.state_tree = bb.state_tree
        self.accounts = bb.accounts
        self.last_idx = bb.new_last_idx
        self.last_batch += 1
        self.exit_trees[self.last_batch] = (bb.exit_tree, bb.exit_accounts)


class BatchBuilder:
    """One batch: collects txs/tokens/fee-idxs, `build()` computes every
    circuit input (bb.build/getInput of commonjs)."""

    def __init__(self, db: RollupDB, max_n_tx, n_levels, max_l1_tx,
                 max_fee_tx):
        self.db = db
        self.maxNTx = max_n_tx
        self.nLevels = n_levels
        self.maxL1Tx = max_l1_tx
        self.totalFeeTransactions = max_fee_tx
        self.chainID = db.chain_id
        self.currentNumBatch = db.last_batch + 1

        self.txs: list[dict] = []
        self.fee_plan_tokens: list[int] = []
        self.fee_idxs: list[int] = []
        self.built = False

        # working copies (consolidate() publishes them)
        self.state_tree = SMT(root=db.state_tree.root,
                              nodes=dict(db.state_tree.nodes))
        self.accounts = {k: AccountState(**v.as_dict())
                         for k, v in db.accounts.items()}
        self.exit_tree = SMT()
        self.exit_accounts: dict[int, AccountState] = {}
        self.new_last_idx = db.last_idx

    # ------------------------------------------------------------------
    # collection phase
    # ------------------------------------------------------------------

    def add_tx(self, tx: dict):
        assert not self.built
        if len(self.txs) >= self.maxNTx:
            raise ValueError("too many txs for this batch")
        t = dict(tx)
        t["onChain"] = bool(t.get("onChain", False))
        if t["onChain"]:
            n_l1 = sum(1 for x in self.txs if x["onChain"])
            if n_l1 >= self.maxL1Tx:
                raise ValueError("too many L1 txs")
            if any(not x["onChain"] for x in self.txs):
                raise ValueError("L1 txs must be added before L2 txs")
        self.txs.append(t)

    def add_token(self, token_id: int):
        assert not self.built
        if len(self.fee_plan_tokens) >= self.totalFeeTransactions:
            raise ValueError("too many fee tokens")
        self.fee_plan_tokens.append(int(token_id))

    def add_fee_idx(self, idx: int):
        assert not self.built
        if len(self.fee_idxs) >= len(self.fee_plan_tokens):
            raise ValueError("add_token before add_fee_idx")
        self.fee_idxs.append(int(idx))

    # ------------------------------------------------------------------
    # build phase
    # ------------------------------------------------------------------

    def _nop_tx(self) -> dict:
        return dict(fromIdx=0, toIdx=0, tokenID=0, amount=0, userFee=0,
                    nonce=0, onChain=False, loadAmountF=0,
                    fromBjjCompressed=0, fromEthAddr=0, toEthAddr=0,
                    toBjjAy=0, maxNumBatch=0, _nop=True)

    def _find_aux_to_idx(self, tx) -> int:
        """Coordinator choice of receiver idx for transferToEthAddr/Bjj."""
        to_eth = _to_int(tx.get("toEthAddr", 0))
        token = _to_int(tx.get("tokenID", 0))
        any_addr = to_eth == Constants.nullEthAddr
        for idx, st in sorted(self.accounts.items()):
            if st.tokenID != token:
                continue
            if any_addr:
                ay = _to_int(tx.get("toBjjAy", 0))
                sign = _to_int(tx.get("toBjjSign", 0))
                if st.ay == ay and st.sign == sign:
                    return idx
            elif st.ethAddr == to_eth:
                return idx
        raise ValueError("transferToEthAddr/Bjj receiver not found")

    def build(self):
        assert not self.built
        nL = self.nLevels
        F = self.totalFeeTransactions
        T = self.maxNTx

        self.input: dict = {k: [] for k in [
            "txCompressedData", "amountF", "txCompressedDataV2", "fromIdx",
            "auxFromIdx", "toIdx", "auxToIdx", "toBjjAy", "toEthAddr",
            "maxNumBatch", "onChain", "newAccount", "rqOffset",
            "rqTxCompressedDataV2", "rqToEthAddr", "rqToBjjAy",
            "s", "r8x", "r8y", "loadAmountF", "fromEthAddr",
            "fromBjjCompressed",
            "tokenID1", "nonce1", "sign1", "balance1", "ay1", "ethAddr1",
            "siblings1", "isOld0_1", "oldKey1", "oldValue1",
            "tokenID2", "nonce2", "sign2", "balance2", "ay2", "ethAddr2",
            "siblings2", "newExit", "isOld0_2", "oldKey2", "oldValue2",
            "imOnChain", "imOutIdx", "imStateRoot", "imExitRoot",
            "imAccFeeOut",
        ]}
        inp = self.input
        inp["oldLastIdx"] = self.db.last_idx
        inp["oldStateRoot"] = self.state_tree.root
        inp["globalChainID"] = self.chainID
        inp["currentNumBatch"] = self.currentNumBatch
        self.old_state_root = self.state_tree.root

        fee_plan = list(self.fee_plan_tokens) + [0] * (
            F - len(self.fee_plan_tokens))
        fee_idxs = list(self.fee_idxs) + [0] * (F - len(self.fee_idxs))
        inp["feePlanTokens"] = fee_plan
        inp["feeIdxs"] = fee_idxs
        acc_fee = [0] * F

        self.l1_full_bits: list[str] = []
        self.l1l2_bits: list[str] = []
        self.is_amount_nullified: list[int] = []

        idx_chain = self.db.last_idx
        txs = [dict(t) for t in self.txs]
        txs += [self._nop_tx() for _ in range(T - len(txs))]
        self.padded_txs = txs

        for i, tx in enumerate(txs):
            idx_chain = self._process_tx(i, tx, idx_chain, acc_fee,
                                         fee_plan)
            if i < T - 1:
                inp["imOnChain"].append(int(tx["onChain"]))
                inp["imOutIdx"].append(idx_chain)
                inp["imStateRoot"].append(self.state_tree.root)
                inp["imExitRoot"].append(self.exit_tree.root)
                inp["imAccFeeOut"].append(list(acc_fee))

        self.new_last_idx = idx_chain
        self.fee_totals = list(acc_fee)
        inp["imFinalAccFee"] = list(acc_fee)
        inp["imInitStateRootFee"] = self.state_tree.root
        self.state_root_before_fees = self.state_tree.root

        # fee transactions (src/fee-tx.circom semantics)
        for k in ["tokenID3", "nonce3", "sign3", "balance3", "ay3",
                  "ethAddr3", "siblings3"]:
            inp[k] = []
        inp["imStateRootFee"] = []
        for j in range(F):
            fee_idx = fee_idxs[j]
            if fee_idx != 0:
                st = self.accounts.get(fee_idx)
                if st is None:
                    raise ValueError(f"fee idx {fee_idx} does not exist")
                if st.tokenID != fee_plan[j]:
                    raise ValueError("fee idx token mismatch")
                inp["tokenID3"].append(st.tokenID)
                inp["nonce3"].append(st.nonce)
                inp["sign3"].append(st.sign)
                inp["balance3"].append(st.balance)
                inp["ay3"].append(st.ay)
                inp["ethAddr3"].append(st.ethAddr)
                st.balance += acc_fee[j]
                proof = self.state_tree.update(fee_idx, st.hash())
                sib = proof["siblings"]
                inp["siblings3"].append(sib + [0] * (nL + 1 - len(sib)))
            else:
                inp["tokenID3"].append(0)
                inp["nonce3"].append(0)
                inp["sign3"].append(0)
                inp["balance3"].append(0)
                inp["ay3"].append(0)
                inp["ethAddr3"].append(0)
                inp["siblings3"].append([0] * (nL + 1))
            if j < F - 1:
                inp["imStateRootFee"].append(self.state_tree.root)

        self.new_state_root = self.state_tree.root
        self.new_exit_root = self.exit_tree.root
        self.built = True
        return self

    # ------------------------------------------------------------------

    def _process_tx(self, i, tx, in_idx, acc_fee, fee_plan) -> int:
        """Mirror of RollupTx phases A-K with host integers; mutates the
        trees and appends this tx's inputs. Returns outIdx."""
        inp = self.input
        nL = self.nLevels
        on_chain = bool(tx["onChain"])
        token_id = _to_int(tx.get("tokenID", 0))
        from_idx = _to_int(tx.get("fromIdx", 0))
        to_idx = _to_int(tx.get("toIdx", 0))
        if "amountF" in tx:
            # L1 txs may specify the raw 40-bit float directly
            # (reference test/rollup-main-L1.test.js passes amountF)
            amount_f = _to_int(tx["amountF"])
            amount = float40.float2fix(amount_f)
        else:
            amount = _to_int(tx.get("amount", 0))
            amount_f = float40.fix2float(amount)
        load_amount_f = _to_int(tx.get("loadAmountF", 0))
        load_amount = float40.float2fix(load_amount_f)
        user_fee = _to_int(tx.get("userFee", 0))
        nonce = _to_int(tx.get("nonce", 0))
        to_eth = _to_int(tx.get("toEthAddr", 0))
        to_ay = _to_int(tx.get("toBjjAy", 0))
        to_sign = _to_int(tx.get("toBjjSign", 0))
        from_eth = _to_int(tx.get("fromEthAddr", 0))
        from_bjj = _bjj_compressed_int(tx.get("fromBjjCompressed", 0))
        max_num_batch = _to_int(tx.get("maxNumBatch", 0))
        new_account = on_chain and from_idx == 0

        # decode checks the engine would enforce
        if not on_chain and not tx.get("_nop"):
            if self.chainID != _to_int(tx.get("chainID", self.chainID)):
                raise ValueError("chainID mismatch")
            if max_num_batch != 0 and max_num_batch < self.currentNumBatch:
                raise ValueError("maxNumBatch exceeded")

        # A - states
        aux_from_idx = 0
        out_idx = in_idx
        if on_chain and new_account:
            out_idx = in_idx + 1
            aux_from_idx = out_idx
        final_from = aux_from_idx if (on_chain and new_account) else from_idx

        aux_to_idx = 0
        sel_aux_to = (not on_chain) and to_idx == 0 and not tx.get("_nop")
        if sel_aux_to:
            aux_to_idx = _to_int(tx.get("auxToIdx", 0)) or \
                self._find_aux_to_idx(tx)
        final_to = aux_to_idx if ((not on_chain) and to_idx == 0) else to_idx

        is_exit = final_to == Constants.exitIdx
        is_p1_insert = on_chain and new_account
        nop = final_from == 0
        is_amount = amount != 0
        is_load = load_amount != 0

        if not on_chain and (is_load or new_account):
            raise ValueError("L2 tx cannot load or create account")

        # sender state (state 1)
        if is_p1_insert:
            decode_ay = from_bjj & ((1 << 254) - 1)
            decode_sign = (from_bjj >> 255) & 1
            s1 = AccountState(tokenID=token_id, nonce=0, sign=decode_sign,
                              balance=0, ay=decode_ay, ethAddr=from_eth,
                              idx=final_from)
            st1_in = AccountState(tokenID=token_id, nonce=0, sign=0,
                                  balance=0, ay=0, ethAddr=from_eth)
        elif not nop:
            st = self.accounts.get(final_from)
            if st is None:
                raise ValueError(f"sender idx {final_from} does not exist")
            s1 = AccountState(**st.as_dict())
            st1_in = AccountState(**st.as_dict())
        else:
            s1 = AccountState(0, 0, 0, 0, 0, 0)
            st1_in = AccountState(0, 0, 0, 0, 0, 0)

        # L2 hard checks (the circuit's ForceEqualIfEnabled set, phase C)
        if not on_chain and not nop:
            if nonce != s1.nonce:
                raise ValueError("nonce mismatch")
            if token_id != s1.tokenID:
                raise ValueError("tokenID mismatch (sender)")

        # nullifier table (rollup-tx-states.circom:250-313)
        nullify_load, nullify_amount = False, False
        if on_chain and not new_account and not nop:
            tok1_bad = token_id != s1.tokenID
            eth_bad = is_amount and from_eth != s1.ethAddr
            nullify_load = tok1_bad and is_load
            nullify_amount = (eth_bad or (tok1_bad and is_amount))

        # receiver existence / newExit decision before tokenID2 nullifier
        exit_res = self.exit_tree.find(final_from) if is_exit else None
        new_exit = bool(is_exit and exit_res is not None
                        and not exit_res.found and is_amount)
        is_p2_insert = is_exit and new_exit

        # receiver state (state 2) as provided to the circuit
        if is_p2_insert:
            st2_in = AccountState(0, 0, 0, 0, 0, 0)
        elif is_exit and is_amount:
            ex = self.exit_accounts.get(final_from)
            if ex is None:
                raise ValueError("exit leaf missing for update")
            st2_in = AccountState(**ex.as_dict())
        elif is_amount and not nop:
            st = self.accounts.get(final_to)
            if st is None:
                raise ValueError(f"receiver idx {final_to} does not exist")
            st2_in = AccountState(**st.as_dict())
        elif not on_chain and not nop:
            # 0-amount L2 tx: processor 2 is NOP but the circuit's
            # tokenID2 / toEthAddr2 / toBjj2 phase-C checks stay enabled
            # (src/rollup-tx.circom:245-277), so state 2 must still carry
            # the real receiver fields (this batch's exit leaf for exits,
            # else the receiver account, else a token-bearing empty state)
            st2_in = AccountState(token_id, 0, 0, 0, 0, 0)
            src = (self.exit_accounts.get(final_from) if is_exit
                   else self.accounts.get(final_to))
            if src is not None:
                st2_in = AccountState(**src.as_dict())
        else:
            st2_in = AccountState(0, 0, 0, 0, 0, 0)

        # L2 receiver checks
        if not on_chain and not nop:
            if sel_aux_to:
                any_addr = to_eth == Constants.nullEthAddr
                if not any_addr and to_eth != st2_in.ethAddr:
                    raise ValueError("toEthAddr mismatch")
                if any_addr and (to_ay != st2_in.ay
                                 or to_sign != st2_in.sign):
                    raise ValueError("toBjj mismatch")
            if is_amount and not is_p2_insert \
                    and token_id != st2_in.tokenID:
                raise ValueError("tokenID mismatch (receiver)")

        # tokenID2 nullifier (L1)
        if on_chain and is_amount and not is_p2_insert and not nop:
            if token_id != st2_in.tokenID:
                nullify_amount = True

        # G - balance updater (balance-updater.circom:24-113)
        apply_fee = (not on_chain) and (not nop)
        fee2_charge = compute_fee(amount, user_fee) if apply_fee else 0
        if apply_fee and fee2_charge >= (1 << 128):
            raise ValueError("fee overflow")
        eff_load = load_amount if on_chain else 0
        eff_load = 0 if nullify_load else eff_load
        eff_amount1 = 0 if nop else amount
        eff_amount2 = 0 if nullify_amount else eff_amount1
        under = s1.balance + eff_load - eff_amount2 - fee2_charge
        underflow_ok = under >= 0
        if not underflow_ok and not on_chain:
            raise ValueError("L2 underflow")
        eff_amount3 = eff_amount2 if underflow_ok else 0
        new_bal_sender = s1.balance + eff_load - eff_amount3 - fee2_charge
        new_bal_receiver = st2_in.balance + eff_amount3
        is_amount_nullified = int(nullify_amount or not underflow_ok)
        is_p2_active = eff_amount1 != 0

        # H - fee accumulation into the first matching slot (the circuit
        # runs this for every tx, including L1/NOP with fee 0)
        for j, t in enumerate(fee_plan):
            if t == token_id:
                acc_fee[j] += fee2_charge
                break

        # J - tree operations
        zeros = [0] * (nL + 1)
        if nop:
            sib1, is_old0_1, old_key1, old_value1 = zeros, 0, 0, 0
        elif is_p1_insert:
            new_leaf = AccountState(tokenID=token_id, nonce=0,
                                    sign=s1.sign, balance=new_bal_sender,
                                    ay=s1.ay, ethAddr=from_eth,
                                    idx=final_from)
            proof = self.state_tree.insert(final_from, new_leaf.hash())
            self.accounts[final_from] = new_leaf
            sib = proof["siblings"]
            sib1 = sib + [0] * (nL + 1 - len(sib))
            is_old0_1 = int(proof["is_old0"])
            old_key1, old_value1 = proof["old_key"], proof["old_value"]
        else:
            new_nonce = s1.nonce + (0 if on_chain else 1)
            upd = AccountState(tokenID=s1.tokenID, nonce=new_nonce,
                               sign=s1.sign, balance=new_bal_sender,
                               ay=s1.ay, ethAddr=s1.ethAddr,
                               idx=final_from)
            proof = self.state_tree.update(final_from, upd.hash())
            self.accounts[final_from] = upd
            sib = proof["siblings"]
            sib1 = sib + [0] * (nL + 1 - len(sib))
            is_old0_1, old_key1, old_value1 = 0, 0, 0

        sib2, is_old0_2, old_key2, old_value2 = zeros, 0, 0, 0
        if is_p2_active and not nop:
            if is_exit:
                # INSERT: exit leaf copies the (possibly just-created)
                # sender account fields (s2* muxes, rollup-tx.circom:390-443)
                ex_leaf = AccountState(
                    tokenID=s1.tokenID, nonce=0, sign=s1.sign,
                    balance=new_bal_receiver, ay=s1.ay,
                    ethAddr=s1.ethAddr, idx=final_from)
                if is_p2_insert:
                    proof = self.exit_tree.insert(final_from,
                                                  ex_leaf.hash())
                    is_old0_2 = int(proof["is_old0"])
                    old_key2 = proof["old_key"]
                    old_value2 = proof["old_value"]
                else:
                    ex_leaf.tokenID = st2_in.tokenID
                    ex_leaf.sign = st2_in.sign
                    ex_leaf.ay = st2_in.ay
                    ex_leaf.ethAddr = st2_in.ethAddr
                    proof = self.exit_tree.update(final_from,
                                                  ex_leaf.hash())
                self.exit_accounts[final_from] = ex_leaf
            else:
                recv = self.accounts[final_to]
                upd2 = AccountState(tokenID=recv.tokenID, nonce=recv.nonce,
                                    sign=recv.sign,
                                    balance=recv.balance + eff_amount3,
                                    ay=recv.ay, ethAddr=recv.ethAddr,
                                    idx=final_to)
                # state2 provided to the circuit is the post-P1 leaf
                st2_in = AccountState(**recv.as_dict())
                proof = self.state_tree.update(final_to, upd2.hash())
                self.accounts[final_to] = upd2
            sib = proof["siblings"]
            sib2 = sib + [0] * (nL + 1 - len(sib))

        # record circuit inputs for this tx slot
        tx_cd = tx_utils.build_tx_compressed_data(dict(
            chainID=self.chainID if not on_chain else
            _to_int(tx.get("chainID", self.chainID)),
            fromIdx=from_idx, toIdx=to_idx, tokenID=token_id, nonce=nonce,
            userFee=user_fee, toBjjSign=bool(to_sign)))
        tx_cd_v2 = 0 if on_chain else tx_utils.build_tx_compressed_data_v2(
            dict(fromIdx=from_idx, toIdx=to_idx, amount=amount,
                 tokenID=token_id, nonce=nonce, userFee=user_fee,
                 toBjjSign=bool(to_sign)))

        inp["txCompressedData"].append(tx_cd)
        inp["amountF"].append(amount_f)
        inp["txCompressedDataV2"].append(tx_cd_v2)
        inp["fromIdx"].append(from_idx)
        inp["auxFromIdx"].append(aux_from_idx)
        inp["toIdx"].append(to_idx)
        inp["auxToIdx"].append(aux_to_idx)
        inp["toBjjAy"].append(to_ay)
        inp["toEthAddr"].append(to_eth)
        inp["maxNumBatch"].append(max_num_batch)
        inp["onChain"].append(int(on_chain))
        inp["newAccount"].append(int(new_account))
        inp["rqOffset"].append(_to_int(tx.get("rqOffset", 0)))
        inp["rqTxCompressedDataV2"].append(
            _to_int(tx.get("rqTxCompressedDataV2", 0)))
        inp["rqToEthAddr"].append(_to_int(tx.get("rqToEthAddr", 0)))
        inp["rqToBjjAy"].append(_to_int(tx.get("rqToBjjAy", 0)))
        inp["s"].append(_to_int(tx.get("s", 0)))
        inp["r8x"].append(_to_int(tx.get("r8x", 0)))
        inp["r8y"].append(_to_int(tx.get("r8y", 0)))
        inp["loadAmountF"].append(load_amount_f)
        inp["fromEthAddr"].append(from_eth)
        inp["fromBjjCompressed"].append(
            [(from_bjj >> b) & 1 for b in range(256)])

        inp["tokenID1"].append(st1_in.tokenID)
        inp["nonce1"].append(st1_in.nonce)
        inp["sign1"].append(st1_in.sign)
        inp["balance1"].append(st1_in.balance)
        inp["ay1"].append(st1_in.ay)
        inp["ethAddr1"].append(st1_in.ethAddr)
        inp["siblings1"].append(sib1)
        inp["isOld0_1"].append(is_old0_1)
        inp["oldKey1"].append(old_key1)
        inp["oldValue1"].append(old_value1)

        inp["tokenID2"].append(st2_in.tokenID)
        inp["nonce2"].append(st2_in.nonce)
        inp["sign2"].append(st2_in.sign)
        inp["balance2"].append(st2_in.balance)
        inp["ay2"].append(st2_in.ay)
        inp["ethAddr2"].append(st2_in.ethAddr)
        inp["siblings2"].append(sib2)
        inp["newExit"].append(int(new_exit))
        inp["isOld0_2"].append(is_old0_2)
        inp["oldKey2"].append(old_key2)
        inp["oldValue2"].append(old_value2)

        # data availability strings
        if on_chain:
            l1 = (_be_bits(from_eth, 160) + _be_bits(from_bjj, 256)
                  + _be_bits(from_idx, 48) + _be_bits(load_amount_f, 40)
                  + _be_bits(amount_f, 40) + _be_bits(token_id, 32)
                  + _be_bits(to_idx, 48))
        else:
            l1 = "0" * L1_TX_FULL_BITS
        self.l1_full_bits.append(l1)

        da_amount_f = 0 if is_amount_nullified else amount_f
        l1l2 = (_be_bits(from_idx, nL) + _be_bits(final_to, nL)
                + _be_bits(da_amount_f, 40)
                + _be_bits(0 if on_chain else user_fee, 8))
        self.l1l2_bits.append(l1l2)
        self.is_amount_nullified.append(is_amount_nullified)
        tx["isAmountNullified"] = bool(is_amount_nullified)

        return out_idx

    # ------------------------------------------------------------------
    # accessors (commonjs BatchBuilder API, SURVEY.md §8)
    # ------------------------------------------------------------------

    def get_input(self) -> dict:
        assert self.built
        return self.input

    def get_l1_txs_full_data(self) -> str:
        bits = list(self.l1_full_bits[:self.maxL1Tx])
        bits += ["0" * L1_TX_FULL_BITS] * (self.maxL1Tx - len(bits))
        return "".join(bits)

    def get_l1l2_txs_data(self) -> str:
        return "".join(self.l1l2_bits)

    def get_fee_txs_data(self) -> str:
        return "".join(_be_bits(i, self.nLevels)
                       for i in self.input["feeIdxs"])

    def get_inputs_str(self) -> str:
        """The exact SHA256 preimage bitstring of HashInputs
        (src/hash-inputs.circom:111-177)."""
        assert self.built
        return (
            _be_bits(self.input["oldLastIdx"], 48)
            + _be_bits(self.new_last_idx, 48)
            + _be_bits(self.old_state_root, 256)
            + _be_bits(self.new_state_root, 256)
            + _be_bits(self.new_exit_root, 256)
            + self.get_l1_txs_full_data()
            + self.get_l1l2_txs_data()
            + self.get_fee_txs_data()
            + _be_bits(self.chainID, 16)
            + _be_bits(self.currentNumBatch, 32)
        )

    def get_hash_inputs(self) -> int:
        return sha256_bitstring(self.get_inputs_str()) % P


def sha256_bitstring(bits: str) -> int:
    """SHA-256 of an arbitrary-length bitstring (the circuit hashes exact
    bit counts; hashlib covers the byte-aligned case, a pure-Python
    compression handles the rest)."""
    if len(bits) % 8 == 0:
        data = (int(bits, 2).to_bytes(len(bits) // 8, "big")
                if bits else b"")
        return int.from_bytes(hashlib.sha256(data).digest(), "big")
    from .sha256_py import sha256_bits_py
    return sha256_bits_py(bits)
