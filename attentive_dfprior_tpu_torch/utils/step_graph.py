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

``ForwardGraphs`` holds the no-gradient programs of the renders and the
point queries the same way, one ``StepGraphs`` per calling thread.

A replay writes its tensors in place without PyTorch seeing it, so it
advances the ``_version`` of the tensors its program names as written (the
parameters it updates): readers that key on ``_version``, as K2's weight
images (``ops/cuda/decoder_kernel.py:TC_CACHE``) do, see a replay's write
as they see an eager step's.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from attentive_dfprior_tpu_torch.ops.adam import AdamState, adam_init, adam_reset
from attentive_dfprior_tpu_torch.utils.profiling import span
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


def pool_bytes(pool) -> int:
    """Device bytes the caching allocator holds in the graph pool ``pool``
    (a ``torch.cuda.graph_pool_handle()``); 0 without CUDA or a pool."""
    if pool is None or not torch.cuda.is_available():
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool))


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
    the capture. Spans (``utils/profiling.py``): ``StepGraph.eager``,
    ``StepGraph.warmup``, ``StepGraph.capture`` (the agent's captures
    after it) and ``StepGraph.replay``, around the ``replay()`` call
    alone."""

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
            with span("StepGraph.eager"):
                self.step()
            o.eager_iters += 1
            return
        if self.graph is None:
            if self.warm < WARMUP_ITERS:
                with span("StepGraph.warmup", iteration=self.warm):
                    o.on_side_stream(self.step)
                self.warm += 1
                o.eager_iters += 1
                return
            with span("StepGraph.capture") as s:
                self._capture()
                if s is not None:
                    s.attrs["captures"] = o.captures
        with span("StepGraph.replay"):  # the host's time in cudaGraphLaunch
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
        copy_scene: ``scene`` copies each new scene snapshot, and each leaf
            written in place since, into a static scene of this agent's
            (the async tracker, the render programs), so its graphs keep
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
        self.scene_copies = 0  # calls of ``scene`` that copied a leaf in
        self._scene = None
        self._sources: List[tuple] = []  # (weakref to the source leaf, its _version) per static leaf

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
        self._scene, self._sources = None, []

    def buffer(self, name: Hashable, shape: Sequence[int], dtype: torch.dtype,
               requires_grad: bool = False) -> torch.Tensor:
        """The static buffer ``name``, allocated at ``shape`` and ``dtype``
        on first use, again if they change (a leaf that requires grad with
        ``requires_grad``, as BA's window poses); its contents as left."""
        buf = self.buffers.get(name)
        if buf is None or tuple(buf.shape) != tuple(shape) or buf.dtype != dtype:
            buf = self.buffers[name] = torch.empty(tuple(shape), dtype=dtype, device=self.device)
            buf.requires_grad_(requires_grad)
        return buf

    def static(self, name: Hashable, value: torch.Tensor, requires_grad: bool = False) -> torch.Tensor:
        """The static buffer ``name`` (``buffer``, at ``value``'s shape and
        dtype) with ``value`` copied in."""
        buf = self.buffer(name, value.shape, value.dtype, requires_grad)
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
        """The scene a step reads: ``params``' leaves detached (the live
        buffers), or with ``copy_scene`` on the card this agent's static
        scene (made at ``params``' shapes, again if they change) with every
        leaf copied in whose source tensor or ``_version`` moved since the
        last copy: another snapshot, or a leaf written in place."""
        if not (self.copy_scene and self.graphed):
            return tree_map(lambda t: t.detach(), params)
        src = tree_leaves(params)
        with torch.no_grad():
            if self._scene is None or [t.shape for t in tree_leaves(self._scene)] != [t.shape for t in src]:
                self._scene = tree_map(lambda t: t.detach().clone(), params)
                self._sources = [(weakref.ref(t), t._version) for t in src]
                self.scene_copies += 1
                return self._scene
            moved = False
            for i, (dst, t) in enumerate(zip(tree_leaves(self._scene), src)):
                ref, version = self._sources[i]
                if ref() is not t or version != t._version:
                    dst.copy_(t.detach())
                    self._sources[i] = (weakref.ref(t), t._version)
                    moved = True
            self.scene_copies += moved
        return self._scene

    def stats(self) -> Dict[str, Any]:
        return {"mode": self.mode, "programs": len(self.programs), "captures": self.captures,
                "replays": self.replays, "eager_iters": self.eager_iters}


class ForwardGraphs:
    """The no-gradient programs of the renders and the point queries
    (``render/renderer.py``, ``models/decoders.py:query_points``): the
    port's counterpart of the JAX package's ``jax.jit`` of ``render_rays``
    per (stage, no_gt_depth) and of ``eval_points_chunk`` (its
    render/renderer.py:225 and models/decoders.py:402), whose callers pad
    the last chunk to the static size so that one executable serves every
    chunk.

    ``mode`` as ``StepGraphs``' (``resolve_step_mode`` with no group):
    ``graph`` by default on a CUDA device, ``eager`` on request and on the
    CPU; ``graph`` on the CPU raises; a failed capture raises. A program
    is one ``StepGraph`` (warmed up, captured once, replayed) that reads
    static inputs the caller fills by device copies and writes static
    outputs; a replay makes no host synchronization and no copy from the
    host. Programs are keyed by their kind, stage, options and chunk size
    and by the data pointers of every tensor they read.

    Three hazards, and the design's answer to each:

    1. K2's weight image inside a capture: ``TC_CACHE`` builds a new image
       whenever a decoder's leaves change, and no capture may build one.
       Each program holds static images of its own, refreshed outside any
       capture before it runs (``ops/cuda/decoder_kernel.py:StaticImages``).
       K2's launches in a replay count as their capture's (``StepGraph``).
    2. Scene buffers that move. The strict mapper's leaves stay at fixed
       addresses, but the async modes publish a fresh clone of every leaf
       to the tracker, and its Visualizer renders that snapshot: programs
       keyed on those pointers would be captured anew on every publish. So
       the programs read a static scene, one per thread; ``scene`` copies
       into it every leaf whose source tensor or ``_version`` moved since
       the last copy (a publish, a mapping step, a checkpoint load). The
       TSDF prior is not copied: its tensors stay put for a run, and the
       programs are keyed on them. Captures per run: programs per thread
       (renders per stage and chunk size, point queries per stage) x
       threads, whatever the number of publishes.
    3. Two threads, one Renderer. ``SLAMSystem`` gives one Renderer to
       both Visualizers, and under loose / free the mapper's worker thread
       and the main thread render at once, each on its own stream. Each
       thread has its own ``StepGraphs``: its pool, side stream, programs
       and static scene; no two threads share a pool or replay one graph.
       With ``concurrent`` (another thread may launch work during a
       capture) captures run in ``thread_local`` error mode.

    ``graph_factory``: as ``StepGraphs``'.
    """

    def __init__(self, mode: Optional[str], device, concurrent: bool = False,
                 graph_factory: Optional[Callable[[], Any]] = None):
        self.device = torch.device(device)
        self.mode = resolve_step_mode(mode, self.device) if graph_factory is None else mode
        self.graphed = self.mode == "graph"
        self.concurrent = concurrent
        self.graph_factory = graph_factory
        self._local = threading.local()
        self._threads: List[StepGraphs] = []
        self._lock = threading.Lock()

    def thread(self) -> StepGraphs:
        """The calling thread's programs, made on its first call."""
        graphs = getattr(self._local, "graphs", None)
        if graphs is None:
            graphs = self._local.graphs = StepGraphs(self.mode, self.device, concurrent=self.concurrent,
                                                     copy_scene=True, graph_factory=self.graph_factory)
            with self._lock:
                self._threads.append(graphs)
        return graphs

    def scene(self, params: Any) -> Any:
        """This thread's static scene with ``params`` copied in where it
        moved (hazard 2; ``StepGraphs.scene``)."""
        return self.thread().scene(params)

    def program(self, key: Hashable, make: Callable[[StepGraphs], Any]) -> Any:
        """This thread's cached program of ``key``, or ``make(graphs)``'s."""
        graphs = self.thread()
        return graphs.program(key, lambda: make(graphs))

    def stats(self) -> Dict[str, Any]:
        """Programs, captures, replays and eager iterations summed over the
        threads, the threads, the scene copies, and the device bytes the
        threads' graph pools hold (GiB)."""
        with self._lock:
            threads = list(self._threads)
        out = {"mode": self.mode, "threads": len(threads)}
        for k in ("programs", "captures", "replays", "eager_iters"):
            out[k] = sum(g.stats()[k] for g in threads)
        out["scene_copies"] = sum(g.scene_copies for g in threads)
        out["pool_gib"] = sum(pool_bytes(g.pool) for g in threads) / 2**30
        return out


def pad_rows(x: torch.Tensor, rows: int, value: float) -> torch.Tensor:
    """``x`` with rows of ``value`` appended up to ``rows``: a chunk padded
    to a program's static size."""
    if x.shape[0] == rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])
