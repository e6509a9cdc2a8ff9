"""One optimization iteration replayed as a CUDA graph: the port's
counterpart of the JAX package's ``jax.jit`` + ``lax.scan`` +
``donate_argnums`` (ref: slam/mapper.py:109-123, 307; slam/tracker.py:120,
239).

An agent (the mapper, the tracker) holds one ``StepGraphs``: its mode, its
memory pool, its side stream, its static buffers and a cache of programs.
A program is one iteration's ``StepGraph`` with the static tensors it reads
and writes: inputs the caller copies into before an iteration, outputs it
reads after, the parameter leaves and the optimizer state, all at fixed
addresses and updated in place (the JAX package donated them).

``mode``:
  - ``eager``: every iteration runs the Python step (on the CPU, for an
    agent on a gloo group, whose collectives cannot be captured, and on
    request);
  - ``graph`` (the default on a CUDA device for an agent with no group of
    its own, one process or a ``parallel.split`` agent alone in its group,
    and for an agent on an NCCL group): the first
    ``WARMUP_ITERS`` iterations of a program run the step on the agent's
    side stream (they are iterations of the stage like the others, and set
    up the allocator, cuBLAS and the kernels' libraries before a capture),
    the next is captured once, and it and every later iteration is a
    replay on the caller's stream. A capture or a replay that fails
    raises: nothing falls back to the eager step.

A step keeps to these rules: no host synchronization and no host-to-device
copy (learning rates and loss weights are 0-d device tensors that the caller
fills before an iteration, ``StaticScalars``), pixel draws from a
``torch.Generator`` registered with the graph
(``CUDAGraph.register_generator_state``: each replay advances it as the
eager step does, so both draw the same pixels) or from a static buffer the
caller fills, and every output written into a static buffer.

Programs are cached by what fixes them: the stage, the shapes, the options
and the data pointers of every tensor the step reads. A cached program
holds its tensors, so a pointer is never reused while its key lives;
``clear`` drops the programs when the caller rebinds its buffers
(``SLAMSystem.resume``). One pool per agent: the mapper and the tracker run
at once in the async modes, so they never share one; the graphs of one
agent run one at a time on its thread and share its pool. While another
thread may launch work during a capture (``concurrent``), the capture runs
in ``thread_local`` error mode.

An agent on an NCCL group (ray-axis dp, ``parallel/sharding.py``) captures
its step's ``all_reduce`` into the graph, as the JAX package's compiled
step holds its psum: the warm-up iterations run the group's first
collectives eagerly, which create its communicator before any capture;
ProcessGroupNCCL orders its own stream after the capturing stream and the
capturing stream after its own by events, which a capture records as graph
edges, and leaves captured work out of its watchdog. The watchdog thread
queries the events of other work while a capture runs, which a capture in
``global`` mode takes for an illegal call, so such an agent captures in
``thread_local`` mode too.

A replay writes its tensors in place without PyTorch seeing it, so it
advances the ``_version`` of the tensors its program names as written (the
parameters it updates): readers that key on ``_version``, as K2's weight
images (``ops/cuda/decoder_kernel.py:TC_CACHE``) do, see a replay's write
as they see an eager step's.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.ops.adam import AdamState, adam_init, adam_reset
from attentive_dfprior_tpu_torch.utils.tree import tree_leaves, tree_map

STEP_MODES = ("graph", "eager")
GLOO_EAGER = "step mode 'graph' on a gloo group: gloo collectives cannot be captured in a CUDA graph; run eager"
WARMUP_ITERS = 2  # eager iterations of a program on the side stream before its capture
MAX_PROGRAMS = 32  # programs an agent keeps (the oldest go first)


def capturable_group(group) -> bool:
    """Whether a graph can hold ``group``'s collectives: no group at all,
    or a group on NCCL (``dist.get_backend``); a gloo group cannot."""
    return group is None or str(dist.get_backend(group)).lower() == "nccl"


def resolve_step_mode(mode: Optional[str], device, group=None) -> str:
    """The step mode of an agent whose collectives run over ``group`` (its
    dp group, None where it has none): ``mode``, or by default ``graph`` on
    a CUDA device where the group is None or on NCCL and ``eager``
    otherwise. ``graph`` on the CPU or on a gloo group raises."""
    dev = torch.device(device)
    if mode is None:
        return "graph" if dev.type == "cuda" and capturable_group(group) else "eager"
    if mode not in STEP_MODES:
        raise ValueError(f"step mode {mode!r} is not one of {STEP_MODES}")
    if mode == "graph" and dev.type != "cuda":
        raise ValueError(f"step mode 'graph' needs a CUDA device, got {dev}: CUDA graphs do not run on the CPU")
    if mode == "graph" and not capturable_group(group):
        raise ValueError(GLOO_EAGER)
    return mode


def graph_pool_bytes() -> int:
    """Device bytes the caching allocator holds in the CUDA graphs' private
    pools (every segment outside the default pool); 0 without CUDA. A
    graph's pool stays reserved while the graph lives, though nothing in it
    counts as allocated between replays."""
    if not torch.cuda.is_available():
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def tensor_key(*trees: Any) -> tuple:
    """The data pointers, shapes and dtypes of every tensor leaf of
    ``trees`` (None leaves as None): the buffers a program reads."""
    out = []
    for tree in trees:
        for t in tree_leaves(tree):
            out.append(None if t is None else (t.data_ptr(), tuple(t.shape), t.dtype))
    return tuple(out)


class StaticScalars:
    """A float32 device vector whose entries are set from host floats,
    each filled in place only when its value changes (no host sync, no
    copy from the host): learning rates and loss weights of a step."""

    def __init__(self, n: int, device: torch.device):
        self.values = torch.zeros((n,), dtype=torch.float32, device=device)
        self._host: List[Optional[float]] = [None] * n

    def set(self, i: int, value: float) -> None:
        value = float(value)
        if self._host[i] != value:
            self.values[i].fill_(value)
            self._host[i] = value

    def set_all(self, values: Sequence[float], start: int = 0) -> None:
        for i, v in enumerate(values):
            self.set(start + i, v)


class StepGraph:
    """One iteration of a program: ``step()`` reads and writes static
    tensors only. Calling it runs one iteration, eagerly, or warmed up,
    captured and replayed (module docstring). ``generators``: the
    ``torch.Generator``s the step draws from. ``writes``: the tensors the
    step updates in place, whose ``_version`` each replay advances.
    ``launches``: the hand-written kernels' launches one replay makes, from
    the capture."""

    def __init__(self, owner: "StepGraphs", step: Callable[[], None], generators: Iterable[torch.Generator] = (),
                 writes: Sequence[torch.Tensor] = ()):
        self.owner = owner
        self.step = step
        self.generators = [g for g in generators if g is not None]
        self.writes = list(writes)
        self.graph: Optional[Any] = None
        self.warm = 0
        self.launches: Dict[Any, int] = {}

    def __call__(self) -> None:
        o = self.owner
        if not o.graphed:
            self.step()
            o.eager_iters += 1
            return
        if self.graph is None:
            if self.warm < WARMUP_ITERS:
                o.on_side_stream(self.step)
                self.warm += 1
                o.eager_iters += 1
                return
            self._capture()
        self.graph.replay()
        for k, n in self.launches.items():
            if n:
                k.count(n)
        if self.writes:
            torch.autograd.graph.increment_version(self.writes)
        o.replays += 1

    def _capture(self) -> None:
        from attentive_dfprior_tpu_torch.ops.cuda.build import port_kernels

        o = self.owner
        kernels = port_kernels()
        graph = o.graph_factory()
        for g in self.generators:
            graph.register_generator_state(g)
        sid = o.stream_id
        for k in kernels:
            k.take_captured(sid)

        def capture():
            graph.capture_begin(pool=o.pool, capture_error_mode=o.capture_error_mode)
            try:
                self.step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the failed step left the capture invalid; its own error is raised
                raise
            graph.capture_end()

        o.on_side_stream(capture)
        self.launches = {k: k.take_captured(sid) for k in kernels}
        self.graph = graph
        o.captures += 1


class StepGraphs:
    """One agent's graphs (module docstring).

    Args:
        mode: ``graph``, ``eager``, or None for ``resolve_step_mode``'s
            default.
        device: the agent's device.
        concurrent: another thread may launch work while this agent
            captures (the async modes): captures run in ``thread_local``
            error mode.
        copy_scene: ``scene`` copies each new scene snapshot into a static
            scene of this agent's (the async tracker), so its graphs keep
            their buffers across publishes.
        graph_factory: makes the graph objects (``torch.cuda.CUDAGraph``;
            a stub in the CPU tests of the launch accounting).
        group: the agent's dp group (``RayShards.group``), None where it
            has none: it fixes the default mode (``resolve_step_mode``),
            and an NCCL group captures in ``thread_local`` error mode.
    """

    def __init__(self, mode: Optional[str], device, concurrent: bool = False, copy_scene: bool = False,
                 graph_factory: Optional[Callable[[], Any]] = None, group=None):
        self.device = torch.device(device)
        self.mode = resolve_step_mode(mode, self.device, group) if graph_factory is None else mode
        self.graphed = self.mode == "graph"
        self.group = group
        self.concurrent = concurrent
        self.copy_scene = copy_scene
        self.graph_factory = graph_factory or torch.cuda.CUDAGraph
        self.pool = torch.cuda.graph_pool_handle() if self.graphed and graph_factory is None else None
        self.stream = torch.cuda.Stream(self.device) if self.graphed and graph_factory is None else None
        self.programs: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.buffers: Dict[Hashable, torch.Tensor] = {}
        self.adam_states: Dict[Hashable, AdamState] = {}
        self.captures = self.replays = self.eager_iters = 0
        self._scene = None
        self._scene_src = None

    @property
    def capture_error_mode(self) -> str:
        return "thread_local" if self.concurrent or self.group is not None else "global"

    @property
    def stream_id(self) -> int:
        """The raw handle of the side stream the captures run on (0 for a
        stub graph)."""
        return self.stream.cuda_stream if self.stream is not None else 0

    def on_side_stream(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` on the side stream, ordered after the caller's stream
        and before its later work."""
        if self.stream is None:
            fn()
            return
        here = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            fn()
        here.wait_stream(self.stream)

    def program(self, key: Hashable, make: Callable[[], Any]) -> Any:
        """The cached program of ``key``, or ``make()``'s, cached."""
        prog = self.programs.get(key)
        if prog is None:
            prog = make()
            self.programs[key] = prog
            while len(self.programs) > MAX_PROGRAMS:
                self.programs.popitem(last=False)
        else:
            self.programs.move_to_end(key)
        return prog

    def step_graph(self, step: Callable[[], None], generators: Iterable[torch.Generator] = (),
                   writes: Sequence[torch.Tensor] = (), shards=None) -> StepGraph:
        """A ``StepGraph`` of this agent; ``shards``: the step's
        ``RayShards``, whose group a graphed agent may hold only on NCCL."""
        if self.graphed and shards is not None and not capturable_group(shards.group):
            raise ValueError(GLOO_EAGER)
        return StepGraph(self, step, generators, writes)

    def clear(self) -> None:
        """Drop every program and the static scene: the caller rebound the
        buffers they read."""
        self.programs.clear()
        self._scene = self._scene_src = None

    def static(self, name: Hashable, value: torch.Tensor, requires_grad: bool = False) -> torch.Tensor:
        """The static buffer ``name`` (allocated at ``value``'s shape and
        dtype on first use, again if they change; a leaf that requires grad
        with ``requires_grad``, as BA's window poses) with ``value`` copied
        in."""
        buf = self.buffers.get(name)
        if buf is None or buf.shape != value.shape or buf.dtype != value.dtype:
            buf = self.buffers[name] = torch.empty(value.shape, dtype=value.dtype, device=self.device)
            buf.requires_grad_(requires_grad)
        with torch.no_grad():
            buf.copy_(value)
        return buf

    def adam(self, name: Hashable, tree: Any) -> AdamState:
        """The static Adam state ``name`` for ``tree``'s leaves, zeroed (a
        fresh state for a new frame, at the same addresses)."""
        state = self.adam_states.get(name)
        shapes = [tuple(t.shape) for t in tree_leaves(tree)]
        if state is None or [tuple(t.shape) for t in tree_leaves(state.m)] != shapes:
            state = self.adam_states[name] = adam_init(tree)
        else:
            adam_reset(state)
        return state

    def scene(self, params: Any) -> Any:
        """The scene a tracking step reads: ``params``' leaves detached (the
        live buffers), or with ``copy_scene`` on the card this agent's static
        scene with ``params`` copied in when it is another snapshot than the
        last one copied."""
        detached = tree_map(lambda t: t.detach(), params)
        if not (self.copy_scene and self.graphed):
            return detached
        if self._scene_src is not params:
            with torch.no_grad():
                shapes = [t.shape for t in tree_leaves(detached)]
                if self._scene is None or [t.shape for t in tree_leaves(self._scene)] != shapes:
                    self._scene = tree_map(lambda t: t.clone(), detached)
                else:
                    for a, b in zip(tree_leaves(self._scene), tree_leaves(detached)):
                        a.copy_(b)
            self._scene_src = params
        return self._scene

    def stats(self) -> Dict[str, Any]:
        return {"mode": self.mode, "programs": len(self.programs), "captures": self.captures,
                "replays": self.replays, "eager_iters": self.eager_iters}
