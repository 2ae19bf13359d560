"""Host-side sparse Merkle tree (circomlib smt.js / SMTMemDB semantics).

This is the tree the batch builder uses to produce circuit inputs: account
state tree and per-batch exit trees (reference usage:
test/rollup-main.test.js:5 `SMTMemDB`, commonjs RollupDB).

Semantics (iden3 compressed SMT):
  * empty tree root = 0
  * leaf node hash  H1(k, v) = Poseidon(k, v, 1)
  * inner node hash H0(l, r) = Poseidon(l, r)
  * key bits traversed LSB-first; a subtree holding exactly one leaf is
    represented by the leaf itself (path compression)

`find` returns the proof data the circuits consume: siblings along the key
path, plus (old_key, old_value, is_old0) describing what occupies the slot.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .poseidon_constants import poseidon_py


def hash0(l: int, r: int) -> int:
    return poseidon_py([l, r])


def hash1(k: int, v: int) -> int:
    return poseidon_py([k, v, 1])


def _bit(key: int, i: int) -> int:
    return (key >> i) & 1


@dataclass
class FindResult:
    found: bool
    siblings: list[int]
    found_value: int = 0
    not_found_key: int = 0
    not_found_value: int = 0
    is_old0: bool = False


@dataclass
class SMT:
    """In-memory SMT (the SMTMemDB equivalent)."""

    root: int = 0
    nodes: dict = field(default_factory=dict)  # hash -> tuple

    def _get(self, h: int):
        return self.nodes[h]

    def find(self, key: int) -> FindResult:
        siblings: list[int] = []
        node = self.root
        level = 0
        while True:
            if node == 0:
                return FindResult(False, siblings, is_old0=True)
            rec = self._get(node)
            if rec[0] == "leaf":
                _, k, v = rec
                if k == key:
                    return FindResult(True, siblings, found_value=v)
                return FindResult(False, siblings, not_found_key=k,
                                  not_found_value=v, is_old0=False)
            _, l, r = rec
            if _bit(key, level):
                siblings.append(l)
                node = r
            else:
                siblings.append(r)
                node = l
            level += 1

    def _put_leaf(self, key: int, value: int) -> int:
        h = hash1(key, value)
        self.nodes[h] = ("leaf", key, value)
        return h

    def _put_node(self, l: int, r: int) -> int:
        h = hash0(l, r)
        self.nodes[h] = ("node", l, r)
        return h

    def _chain_up(self, sub: int, key: int, siblings: list[int]) -> int:
        """Hash `sub` up through `siblings` (oriented by key bits)."""
        rt = sub
        for i in range(len(siblings) - 1, -1, -1):
            if _bit(key, i):
                rt = self._put_node(siblings[i], rt)
            else:
                rt = self._put_node(rt, siblings[i])
        return rt

    def insert(self, key: int, value: int) -> dict:
        """Insert; returns the proof dict the SMTProcessor circuit consumes
        (raw find-siblings, not the extended push-down path)."""
        res = self.find(key)
        if res.found:
            raise KeyError(f"key {key} already exists")
        old_root = self.root
        siblings = list(res.siblings)
        if res.is_old0:
            ext = siblings
            sub = self._put_leaf(key, value)
        else:
            # push the colliding old leaf down to the first differing bit
            ext = list(siblings)
            i = len(ext)
            while _bit(res.not_found_key, i) == _bit(key, i):
                ext.append(0)
                i += 1
            old_leaf = hash1(res.not_found_key, res.not_found_value)
            ext.append(old_leaf)
            sub = self._put_leaf(key, value)
        self.root = self._chain_up(sub, key, ext)
        return {
            "old_root": old_root,
            "new_root": self.root,
            "siblings": siblings,
            "old_key": res.not_found_key if not res.is_old0 else 0,
            "old_value": res.not_found_value if not res.is_old0 else 0,
            "is_old0": res.is_old0,
            "new_key": key,
            "new_value": value,
        }

    def update(self, key: int, value: int) -> dict:
        res = self.find(key)
        if not res.found:
            raise KeyError(f"key {key} not found")
        old_root = self.root
        sub = self._put_leaf(key, value)
        self.root = self._chain_up(sub, key, res.siblings)
        return {
            "old_root": old_root,
            "new_root": self.root,
            "siblings": list(res.siblings),
            "old_key": key,
            "old_value": res.found_value,
            "is_old0": False,
            "new_key": key,
            "new_value": value,
        }

    def delete(self, key: int) -> dict:
        """Delete; mirrors circomlib smt.js: if the deleted leaf's sibling
        subtree is a single leaf, it is pulled up through empty levels."""
        res = self.find(key)
        if not res.found:
            raise KeyError(f"key {key} not found")
        old_root = self.root
        siblings = list(res.siblings)
        # determine replacement subtree at the deleted leaf's position
        is_old0 = True
        old_key, old_value = 0, 0
        proof_siblings = list(siblings)
        if siblings:
            sib = siblings[-1]
            rec = self.nodes.get(sib)
            if rec is not None and rec[0] == "leaf":
                # sibling is a leaf: pull it up while the path has 0 siblings
                is_old0 = False
                old_key, old_value = rec[1], rec[2]
                proof_siblings = list(siblings[:-1])
                while proof_siblings and proof_siblings[-1] == 0:
                    proof_siblings.pop()
                sub = sib
                self.root = self._chain_up(sub, key, proof_siblings)
            else:
                sub = 0
                self.root = self._chain_up(sub, key, siblings)
                # trim trailing zero levels is not needed: empty slot keeps shape
        else:
            self.root = 0
        return {
            "old_root": old_root,
            "new_root": self.root,
            "siblings": proof_siblings,
            "old_key": old_key,
            "old_value": old_value,
            "is_old0": is_old0,
            "del_key": key,
            "del_value": res.found_value,
        }

    def get(self, key: int):
        res = self.find(key)
        return res.found_value if res.found else None
