"""The compiled engines: RollupMain and Withdraw captured once as a CUDA
graph at their input shapes and replayed for each batch.

Port of `circuits_tpu/engine/aot.py` and of the `jax.jit` that the JAX
package's `RollupEngine` and `WithdrawEngine` hold
(`circuits_tpu/engine/witness.py`): there the monomorphised circuit is
traced from the shapes of its packed input, compiled once into one program
and run for each batch. Here the engine's eager path -- the plain PyTorch
field operations and the kernels of `csrc/` -- is recorded once by
`torch.cuda.graph` on static input buffers of the same shapes
(`rollup_input_shapes`, `withdraw_input_shapes`). Each batch is copied into
those buffers and the graph is replayed: the same kernels with the same
arguments, launched from the graph in one call instead of op by op from
Python. The arithmetic is the eager path's own. The debug routes that the
JAX package jits are captured in the same way, with trees of every
intermediate as outputs: `RollupEngine.debug_call`, whose one evaluation
`_trace_lanes`, `_full_debug` and `r1cs.checker.check_batch` read, and
`WithdrawEngine.run_debug`'s call of each width.

`CapturedCall` follows PyTorch's recipe: an eager run first, which builds
the kernel library, puts its constants on the device and fills every
cached table and constant, then one captured call. The eager run is the
caller's first batch (or, for a capture made ahead, one run on zero
inputs). Any batch serves: nothing on either path reads a value back to
the host or branches on one, and nothing copies from the host
(`tests/test_torch_aot.py` holds this on the CPU, op by op).

Divergence: the JAX module's `export_rollup_main` / `load_rollup_main`
have no counterpart. A CUDA graph holds device pointers and the process's
loaded kernels, so it cannot be written to disk; a fresh process captures
anew (`RollupEngine.compile`, the CLI's `compile` verb).
"""

from __future__ import annotations

import ctypes
import time

import torch

from .. import kernels, spans
from ..field.fr import N_LIMBS

_I64 = torch.int64
# cuGraphNodeGetType's CU_GRAPH_NODE_TYPE_KERNEL
_KERNEL_NODE = 0


def rollup_input_shapes(n_tx: int, n_levels: int, max_l1_tx: int,
                        max_fee_tx: int) -> dict:
    """{name: (shape, dtype)} of the packed RollupMain input dict, as
    `engine.witness.pack_rollup_inputs` makes it: limbs, bits and flags all
    int64."""
    T, F, L = n_tx, max_fee_tx, n_levels + 1

    def i64(*s):
        return (s, _I64)

    shapes = {}
    for k in ("old_last_idx", "old_state_root", "global_chain_id",
              "current_num_batch", "im_init_state_root_fee"):
        shapes[k] = i64(N_LIMBS, 1)
    per_tx = (
        "tx_compressed_data", "amount_f", "tx_compressed_data_v2",
        "from_idx", "aux_from_idx", "to_idx", "aux_to_idx", "to_bjj_ay",
        "to_eth_addr", "max_num_batch", "rq_tx_compressed_data_v2",
        "rq_to_eth_addr", "rq_to_bjj_ay", "s", "r8x", "r8y",
        "load_amount_f", "from_eth_addr",
        "token_id1", "nonce1", "balance1", "ay1", "eth_addr1",
        "old_key1", "old_value1",
        "token_id2", "nonce2", "balance2", "ay2", "eth_addr2",
        "old_key2", "old_value2")
    for k in per_tx:
        shapes[k] = i64(N_LIMBS, T)
    for k in ("on_chain", "new_account", "new_exit", "is_old0_1",
              "is_old0_2", "sign1", "sign2", "rq_offset"):
        shapes[k] = i64(T)
    for k in ("fee_plan_tokens", "fee_idxs", "im_final_acc_fee",
              "token_id3", "nonce3", "balance3", "ay3", "eth_addr3"):
        shapes[k] = i64(N_LIMBS, F)
    shapes["sign3"] = i64(F)
    shapes["from_bjj_compressed"] = i64(256, T)
    shapes["siblings1"] = i64(L, N_LIMBS, T)
    shapes["siblings2"] = i64(L, N_LIMBS, T)
    shapes["siblings3"] = i64(L, N_LIMBS, F)
    shapes["im_on_chain"] = i64(T - 1)
    shapes["im_out_idx"] = i64(N_LIMBS, T - 1)
    shapes["im_state_root"] = i64(N_LIMBS, T - 1)
    shapes["im_exit_root"] = i64(N_LIMBS, T - 1)
    shapes["im_state_root_fee"] = i64(N_LIMBS, F - 1)
    shapes["im_acc_fee_out"] = i64(F, N_LIMBS, T - 1)
    return shapes


def withdraw_input_shapes(n_levels: int, lanes: int) -> dict:
    """{name: (shape, dtype)} of the packed Withdraw input dict of `lanes`
    withdrawals, as `engine.witness.pack_withdraw_inputs` makes it."""
    shapes = {k: ((N_LIMBS, lanes), _I64) for k in
              ("root_exit", "eth_addr", "token_id", "balance", "idx", "ay")}
    shapes["sign"] = ((lanes,), _I64)
    shapes["siblings_state"] = ((n_levels + 1, N_LIMBS, lanes), _I64)
    return shapes


def _tree_map(fn, tree):
    """`fn` on every tensor of a tree of dicts, tuples and lists; any other
    leaf (an int, a string, None) is passed through as it is."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _copy_into(dst, src) -> None:
    """Copy a tree of tensors into another of the same structure. A leaf
    that is no tensor was fixed when the call was captured, as a graph
    fixes it: it must come out the same."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    elif isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif dst != src:
        raise RuntimeError(
            f"CapturedCall: an output that is no tensor changed from {dst!r} "
            f"to {src!r}; a captured graph cannot replay a value that "
            "depends on the data")


def pinned_device(device) -> torch.device:
    """`device` as a tensor on it names it: "cuda" pinned to the current
    card's index. Raises ValueError for a device other than the CPU or a
    card."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"CapturedCall: unsupported device {device}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def graph_pool(device):
    """A memory pool that the graphs captured on `device` may share (None
    on the CPU).

    Graphs of different functions may share it, in any order of replay, on
    two conditions that `CapturedCall` keeps: no two of them replay at the
    same time (one stream), and a replay's static outputs are cloned before
    any other graph replays, since another graph's intermediates may lie
    where they do. The static inputs are allocated before the capture,
    outside the pool, so no graph writes them."""
    device = torch.device(device)
    return torch.cuda.graph_pool_handle() if device.type == "cuda" else None


def _libcuda() -> ctypes.CDLL:
    cu = ctypes.CDLL("libcuda.so.1")
    P, PP = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    for name, argtypes in (
            ("cuGraphGetNodes", [P, P, ctypes.POINTER(ctypes.c_size_t)]),
            ("cuGraphNodeGetType", [P, ctypes.POINTER(ctypes.c_int)]),
            ("cuGraphKernelNodeGetParams_v2", [P, PP])):
        fn = getattr(cu, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return cu


def graph_kernels(graph: torch.cuda.CUDAGraph, device) -> tuple[int, dict]:
    """(nodes, {launches key: kernel nodes}) of a captured graph, read from
    the graph: each kernel node whose function is one of the kernel
    library's (`kernels.functions`); the other nodes are PyTorch's own
    kernels and copies."""
    handles = kernels.functions(torch.device(device))
    cu = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    kernels.check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)),
                  "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    kernels.check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)),
                  "cuGraphGetNodes")
    counts = {k: 0 for k in kernels.launches}
    kind = ctypes.c_int()
    # CUDA_KERNEL_NODE_PARAMS_v2 (72 bytes), the function first
    params = (ctypes.c_void_p * 16)()
    for node in nodes:
        kernels.check(cu.cuGraphNodeGetType(node, ctypes.byref(kind)),
                      "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        kernels.check(cu.cuGraphKernelNodeGetParams_v2(node, params),
                      "cuGraphKernelNodeGetParams")
        name = handles.get(params[0])
        if name is not None:
            counts[name] += 1
    return n.value, counts


class CapturedCall:
    """`fn(inputs)` on static input buffers of fixed shapes: run op by op at
    its first call, captured at its second, replayed from then on.

    `fn` takes a dict of tensors and returns a tree (dicts, tuples, lists)
    of tensors; a leaf that is no tensor is passed through. Each call copies
    a packed dict into the static inputs (shapes, dtypes and device must be
    those given, else ValueError). The first call runs `fn` on them eagerly
    -- the warm-up a capture needs, on the caller's own batch -- and
    returns its outputs. The second call captures and replays, later ones
    replay. Every call returns clones, leaf by leaf, so two batches never
    share memory, with each other or with the static buffers: two leaves
    that are one tensor, or a leaf that is a static input passed through,
    come back as clones of their own. `capture()` made before any call (an
    engine's `compile()`) first warms up on zero inputs on a side stream.

    On a CUDA device the capture records one call as a CUDA graph, in
    `pool` (see `graph_pool`) or else a private pool. A kernel wrapper that
    is called while the graph is recorded runs nothing: its count is taken
    back out of `kernels.launches`, and a replay adds nothing to it.
    `counts` is read from the graph (`graph_kernels`): its kernel nodes by
    kernel, which must equal the wrappers' calls during the recording, else
    RuntimeError. A replay runs `counts`; `replays` counts the replays, so
    the kernels that replays launched are `counts` x `replays`.

    `route` names the call in its spans (`spans.py`). A replay records
    `aot.replay` around the whole call (the load, the replay, the clones)
    and, where there is a graph, `aot.launch` around `graph.replay()` alone,
    the host's submission, and the device interval `aot.graph` between two
    timing events recorded just before and just after it on the current
    stream: the graph's device time, with any wait for the submission.
    Nothing is added to the graph.

    On the CPU there is no graph: the capture's call is a plain call of `fn`
    on the batch, whose outputs become the static outputs, and a replay a
    plain call copied into them -- the bookkeeping of the card.
    """

    def __init__(self, fn, shapes: dict, device, pool=None, route=""):
        self.fn = fn
        self.route = route
        self.shapes = shapes
        self.device = pinned_device(device)
        self.pool = pool
        self._inputs = None
        self.warm = False  # `fn` has run on these buffers
        self.graph = None
        self.outputs = None
        self.counts = {k: 0 for k in kernels.launches}
        self.nodes = 0
        self.replays = 0
        self._events = []  # timing event pairs, reused (spans.event_pair)
        # host seconds of the warm-up (when the capture made it), the
        # recording, the instantiation and the count of the graph's nodes
        self.seconds = {}

    @property
    def inputs(self) -> dict:
        """The static input buffers (allocated at first use, zero)."""
        if self._inputs is None:
            self._inputs = {k: torch.zeros(s, dtype=d, device=self.device)
                            for k, (s, d) in self.shapes.items()}
        return self._inputs

    def capture(self) -> None:
        """Record `fn` at these shapes (once)."""
        if self.outputs is not None:
            raise RuntimeError("CapturedCall: already captured")
        if self.device.type == "cpu":
            self.outputs = _tree_map(torch.clone, self.fn(self.inputs))
            self.warm = True
            return
        dev, warm_up = self.device, not self.warm
        t0 = time.perf_counter()
        if warm_up:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.fn(self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.warm = True
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(kernels.launches)
        try:
            with torch.cuda.device(dev), \
                    torch.cuda.graph(graph, pool=self.pool):
                outputs = self.fn(self.inputs)
        finally:
            called = {k: kernels.launches[k] - before[k] for k in before}
            kernels.launches.update(before)
        t2 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        nodes, counts = graph_kernels(graph, dev)
        if counts != called:
            raise RuntimeError(
                f"CapturedCall: the graph holds the kernel nodes {counts}, "
                f"but the wrappers launched {called} while it was recorded")
        self.graph, self.outputs = graph, outputs
        self.nodes, self.counts = nodes, counts
        self.seconds = {"warmup": t1 - t0} if warm_up else {}
        self.seconds.update(capture=t2 - t1, instantiate=t3 - t2,
                            count=time.perf_counter() - t3)

    def load(self, packed: dict) -> None:
        """Copy `packed` into the static inputs."""
        if packed.keys() != self.shapes.keys():
            raise ValueError(
                "CapturedCall: inputs differ from the captured ones: missing "
                f"{sorted(self.shapes.keys() - packed.keys())}, extra "
                f"{sorted(packed.keys() - self.shapes.keys())}")
        for k, (shape, dtype) in self.shapes.items():
            v = packed[k]
            if (tuple(v.shape), v.dtype, v.device) != (tuple(shape), dtype,
                                                       self.device):
                raise ValueError(
                    f"CapturedCall: {k} is {tuple(v.shape)} {v.dtype} on "
                    f"{v.device}; captured for {tuple(shape)} {dtype} on "
                    f"{self.device}")
        for k, buf in self.inputs.items():
            buf.copy_(packed[k])

    def replay(self) -> None:
        """Run the captured call on the static inputs."""
        if self.outputs is None:
            raise RuntimeError("CapturedCall: replay before capture")
        if self.graph is None:
            _copy_into(self.outputs, self.fn(self.inputs))
        else:
            start, end = spans.event_pair(self._events)
            t = time.perf_counter_ns()
            start.record()
            with spans.span("aot.launch", route=self.route):
                self.graph.replay()
            end.record()
            spans.device_interval("aot.graph", start, end, t,
                                  route=self.route)
        self.replays += 1

    def __call__(self, packed: dict):
        if self.outputs is not None:
            with spans.span("aot.replay", route=self.route):
                self.load(packed)
                self.replay()
                return _tree_map(torch.clone, self.outputs)
        self.load(packed)
        if not self.warm:
            out = self.fn(self.inputs)
            self.warm = True
            return _tree_map(torch.clone, out)
        self.capture()
        if self.graph is None:  # the CPU's capture ran this batch
            return _tree_map(torch.clone, self.outputs)
        self.replay()
        return _tree_map(torch.clone, self.outputs)
