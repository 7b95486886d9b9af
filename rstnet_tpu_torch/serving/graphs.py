"""One serving step captured as a CUDA graph and replayed (the PyTorch idiom
for the JAX server's ``jax.jit(step, donate_argnums=...)``).

A step is a function ``fn(state, *inputs) -> (outputs, new_state)`` over a
tree of tensors (dicts, lists, tuples). :class:`CapturedStep` holds the
state and the inputs as static buffers: the caller writes each input buffer
in place before a call, and every call leaves the new state in the same
state buffers. Where ``fn`` returns a state tensor that is not the one it
was given (a conv carry, an offset), the capture ends with a copy of it into
the state buffer; a tensor that ``fn`` writes in place (a ring) needs none.

The first call runs ``fn`` eagerly on the capture stream: it is a real
step whose results are returned, and it allocates whatever a kernel keeps
per stream (K1's and K3's scratch, cuBLAS's workspace) before the capture.
The second call captures the step into a graph in the shared memory
``pool`` and replays it; later calls only replay. A capture that
fails raises: nothing falls back to eager.

The graph bakes in every pointer it reads, the weights' too. ``key``, when
given, names the weights (see :func:`weights_key`); a call that finds it
changed drops the graph and warms up and captures again, into a new pool,
so a graph never runs over weights that were replaced or written since.

``outputs`` are static: the next call overwrites them, so a caller copies
out what it keeps before the next call on the same stream is issued.

A model placed over several ranks (``DTensor`` or FSDP2 parameters) is
refused by :func:`check_capturable`, which a ``CapturedStep`` runs over
the ``modules`` it is given: its frame runs gloo collectives,
which a CUDA graph cannot capture, and nothing falls back to eager
unannounced. Such a frame runs eagerly (``LMGen.step``).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts (in key order), lists and tuples."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_containers(tree):
    """A copy of the tree's containers over the same leaves, so that a step
    that assigns into its state dicts leaves the caller's tree as it was."""
    if isinstance(tree, dict):
        return {k: tree_containers(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_containers(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_containers(v) for v in tree)
    return tree


def copy_tree_(dst, src) -> None:
    """Copy every tensor leaf of ``src`` into the leaf of ``dst`` at the same
    place, in place; a leaf that is already ``dst``'s is skipped. The trees
    must have one structure, and their non-tensor leaves must be equal."""
    dst_leaves, src_leaves = tree_leaves(dst), tree_leaves(src)
    if len(dst_leaves) != len(src_leaves):
        raise ValueError(f"state trees differ: {len(dst_leaves)} and {len(src_leaves)} leaves")
    for d, s in zip(dst_leaves, src_leaves):
        if d is s:
            continue
        if not torch.is_tensor(d):
            if d != s:
                raise ValueError(f"a non-tensor state leaf changed: {d!r} -> {s!r}")
            continue
        if d.shape != s.shape:
            raise ValueError(f"a state tensor changed shape: {tuple(d.shape)} -> {tuple(s.shape)}")
        if s.untyped_storage().data_ptr() == d.untyped_storage().data_ptr():
            s = s.clone()  # a view of the buffer it replaces
        d.copy_(s)


def check_capturable(*modules: torch.nn.Module) -> None:
    """Raise if a module holds parameters sharded over ranks (``DTensor`` s
    or an FSDP2 unit): their collectives (gloo's) cannot be captured into a
    CUDA graph, and a replay would skip them."""
    from torch.distributed.fsdp import FSDPModule

    from rstnet_tpu_torch.parallel.sharding import is_dtensor

    for m in modules:
        sharded = any(is_dtensor(p) for p in m.parameters())
        if sharded or any(isinstance(sub, FSDPModule) for sub in m.modules()):
            raise ValueError(
                f"{type(m).__name__} is placed over several ranks (DTensor or FSDP2 "
                "parameters): its frame runs gloo collectives, which a CUDA graph cannot "
                "capture; run it eagerly (LMGen.step)")


def weights_key(*modules: torch.nn.Module) -> tuple:
    """The addresses of every parameter and buffer of ``modules`` and the
    parameters' versions: it changes when a weight is replaced (padding,
    int8 quantization) or a parameter is written in place, since a replay
    may read a copy taken from it (K1's bf16 rounding of float32 stacks,
    ``ops/cuda_depformer.py::bf16_rounding``)."""
    return (tuple(t.data_ptr() for m in modules for t in (*m.parameters(), *m.buffers())),
            tuple(p._version for m in modules for p in m.parameters()))


# cuBLAS keeps a workspace for every stream it has run on until the process
# ends, so steps made anew for every call share one capture stream a device
# (a new stream a call held ~1 GiB once the pool's 32 streams had each run one)
_CAPTURE_STREAMS: dict = {}


def capture_stream(device) -> torch.cuda.Stream:
    """The side stream that short-lived :class:`CapturedStep` s of ``device``
    share (pass it as ``stream``)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


class CapturedStep:
    """``fn(state, *inputs)`` as a CUDA graph over static buffers.
    ``modules``: the modules whose weights ``fn`` reads, refused when they
    are sharded (:func:`check_capturable`)."""

    def __init__(self, fn: Callable, state, inputs: tuple = (), *, pool=None,
                 stream: Optional[torch.cuda.Stream] = None, generators: tuple = (),
                 key: Optional[Callable[[], tuple]] = None, name: str = "step",
                 modules: tuple = ()):
        check_capturable(*modules)
        self.fn, self.state, self.inputs = fn, state, tuple(inputs)
        self.pool = pool if pool is not None else torch.cuda.graph_pool_handle()
        self.stream = stream if stream is not None else torch.cuda.Stream()
        self.generators, self.key, self.name = tuple(generators), key, name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.warmed_up = False  # the eager call since the last (re)start ran
        self.captures = 0
        self.replays = 0
        self.capture_ms = 0.0  # wall time of the last capture
        self._key = key() if key is not None else None

    def _run(self):
        outputs, new_state = self.fn(tree_containers(self.state), *self.inputs)
        copy_tree_(self.state, new_state)
        return outputs

    def _eager(self):
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            outputs = self._run()
        main.wait_stream(self.stream)
        for t in tree_leaves(outputs):
            if torch.is_tensor(t):
                t.record_stream(main)
        return outputs

    def capture(self) -> None:
        """Capture the step (the caller has warmed it up on ``stream``)."""
        import time

        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            try:
                outputs = self._run()
            except BaseException as e:
                try:
                    graph.capture_end()
                except Exception:  # noqa: BLE001 - the capture's own error is the one to raise
                    pass
                raise RuntimeError(f"CUDA graph capture of {self.name} failed: {e}") from e
            graph.capture_end()
        self.graph, self.outputs = graph, outputs
        self.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1000.0

    def __call__(self):
        """One step: its outputs (static once captured)."""
        if self.key is not None:
            key = self.key()
            if key != self._key:  # weights replaced: never replay the old graph
                self._key, self.graph, self.outputs, self.warmed_up = key, None, None, False
                # a pool dies with the last graph that used it
                self.pool = torch.cuda.graph_pool_handle()
        if self.graph is None:
            if not self.warmed_up:
                self.warmed_up = True
                return self._eager()
            self.capture()
        self.graph.replay()
        self.replays += 1
        return self.outputs
