"""Graph compiler: host node graph -> one jitted superblock render function.

The reference renders by recursive pull with per-node virtual dispatch and
per-block memoization (AudioNode.ProcessInternal, AudioNode.cs:152-183;
AudioNodeOutput.ProcessIfNeeded, AudioNodeOutput.cs:75-78). Here that
becomes: topologically sort the DAG once on the host, resolve static channel
counts, then emit a single pure function

    step(states, encs, frame0) -> (new_states, dest_out[f32, channels, T])

that evaluates every node for a superblock of S render quanta (T = S*128
frames). Offline rendering scans this function over superblocks with
``lax.scan``; XLA fuses the whole graph into a handful of kernels.

Cycle detection mirrors the reference's runtime throw (AudioNode.cs:157-160)
but happens at compile time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.core.mixing import adapt_channels, resolve_channel_count
from graphaudio_tpu.core.params import AutomationRate
from graphaudio_tpu.ops.param_eval import eval_intrinsic_blocked


@dataclass(frozen=True)
class StaticRenderInfo:
    """Compile-time render geometry handed to node kernels."""

    sample_rate: int
    superblock: int  # S: quanta per device step

    @property
    def frames(self) -> int:  # T
        return self.superblock * FRAMES_PER_BLOCK


class RenderContext:
    """Per-step traced context: clocks for one superblock.

    Times are float64, matching the reference's double block clock
    (AudioContextBase.cs:17,64-79). The reference ACCUMULATES the clock —
    ``t += fl(128/sr)`` once per block — rather than recomputing it from the
    frame index, and automation event times routinely land exactly on sample
    instants, so the two schemes classify boundary samples differently.
    ``block_times`` therefore comes in as data (host-accumulated with the
    reference's exact rounding sequence); deriving from ``frame0`` is only a
    fallback for probes that don't thread a clock through.
    """

    def __init__(self, info: StaticRenderInfo, frame0, block_times=None):
        self.info = info
        self.sample_rate = info.sample_rate
        self.superblock = info.superblock
        self.frames = info.frames
        self.frame0 = frame0  # i64 scalar: absolute frame index of sample 0
        sr = jnp.float64(info.sample_rate)
        # fl(1/sr): the reference's per-sample deltaTime (AudioParam.cs:116).
        self.dt = jnp.float64(1.0) / sr
        inc = jnp.float64(FRAMES_PER_BLOCK) / sr
        if block_times is None:
            block_offsets = (
                jnp.arange(info.superblock, dtype=jnp.int64) * FRAMES_PER_BLOCK
            )
            block_times = (frame0 + block_offsets).astype(jnp.float64) / sr
        self.block_times = block_times
        # t1 = t0 + fl(128/sr) (AudioBufferSourceNode.cs:134).
        self.block_end_times = block_times + inc
        in_block = jnp.arange(FRAMES_PER_BLOCK, dtype=jnp.float64) * self.dt
        # Per-sample times, exactly blockTime + i*deltaTime per the
        # reference's a-rate evaluation (AudioParam.cs:116-120).
        self.sample_times = (self.block_times[:, None] + in_block[None, :]).reshape(-1)
        # Per-stage extras, set by the step runner around each single stage.
        self.stage_consts = {}
        self.part_axis = None


class ParamSignal:
    """Computed values of one AudioParam for a superblock.

    ``per_sample()`` yields f32[T]; ``per_block()`` yields f32[S] (the value a
    k-rate consumer sees for each 128-frame quantum, reference
    ``GetValues()[0]``).
    """

    def __init__(self, values, is_a_rate: bool, superblock: int):
        self._values = values
        self._a_rate = is_a_rate
        self._S = superblock

    def per_sample(self):
        if self._a_rate:
            return self._values
        return jnp.repeat(self._values, FRAMES_PER_BLOCK, total_repeat_length=self._S * FRAMES_PER_BLOCK)

    def per_block(self):
        if self._a_rate:
            return self._values.reshape(self._S, FRAMES_PER_BLOCK)[:, 0]
        return self._values


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _is_buffer_source(node) -> bool:
    """Buffer sources batch over a packed sample arena (duck-typed to avoid an
    import cycle with the nodes package)."""
    return hasattr(node, "_process_unity") and hasattr(node, "_buffer")


class CompiledGraph:
    """Static schedule for a graph topology.

    Holds the topo order, resolved per-port channel counts, and param encoding
    capacities. Structure is immutable; re-built when topology changes.
    """

    def __init__(self, context):
        self.context = context
        self.info = StaticRenderInfo(context.sample_rate, context.superblock)
        self.destination = context.destination
        # Multi-chip: when the context carries a Mesh with a 'voice' axis,
        # group stages shard their lane axis across it (set_mesh()).
        self.mesh = getattr(context, "mesh", None)
        self.topo: List = []
        self.input_channels: Dict[Tuple[int, int], int] = {}  # (nid, in_idx) -> c
        self.output_channels: Dict[Tuple[int, int], int] = {}  # (nid, out_idx) -> c
        self.param_capacity: Dict[Tuple[int, str], int] = {}
        self._build()

    # -- topology -------------------------------------------------------------

    def _build(self) -> None:
        dest = self.destination
        # DFS from the destination through input connections and param
        # modulation sources (reference GetAllNodes, AudioContextBase.cs:191-218,
        # extended to param inputs which the reference reaches via
        # AudioParam._input pulls).
        WHITE, GREY, BLACK = 0, 1, 2
        color: Dict[int, int] = {}
        topo: List = []

        def upstream(node):
            ups = []
            for inp in node.inputs:
                for out in inp.connected_outputs:
                    ups.append(out.owner)
            for param in node.params.values():
                for out in param._mod_outputs:
                    ups.append(out.owner)
            return ups

        # Iterative DFS: long serial cascades (the chain-fusion use case)
        # can exceed Python's recursion limit at ~1000 nodes.
        stack = [(dest, False)]
        while stack:
            node, expanded = stack.pop()
            c = color.get(node.node_id, WHITE)
            if expanded:
                color[node.node_id] = BLACK
                topo.append(node)
                continue
            if c == BLACK:
                continue
            if c == GREY:
                raise RuntimeError(
                    f"Audio graph cycle detected at node {node.name} "
                    f"(ID: {node.node_id})"
                )
            color[node.node_id] = GREY
            stack.append((node, True))
            for up in upstream(node):
                uc = color.get(up.node_id, WHITE)
                if uc == GREY:
                    raise RuntimeError(
                        f"Audio graph cycle detected at node {up.name} "
                        f"(ID: {up.node_id})"
                    )
                if uc == WHITE:
                    stack.append((up, False))
        self.topo = topo

        # Static channel resolution in topo order (replaces the reference's
        # per-block dynamic resolution, AudioNodeInput.cs:140-168).
        node_in_counts = {}
        for node in topo:
            in_counts = []
            for inp in node.inputs:
                src_counts = [
                    self.output_channels[(o.owner.node_id, o.index)]
                    for o in inp.connected_outputs
                ]
                c = resolve_channel_count(
                    inp.channel_count_mode.value, inp.channel_count, src_counts
                )
                self.input_channels[(node.node_id, inp.index)] = c
                in_counts.append(c)
            node_in_counts[node.node_id] = tuple(in_counts)
            out_counts = node.output_channel_counts(in_counts)
            for i, c in enumerate(out_counts):
                self.output_channels[(node.node_id, i)] = c

        # ---- stage scheduling with voice batching --------------------------
        # Nodes whose upstream dependencies are all emitted and that share a
        # group_key run as one vmapped stage. This collapses N same-type voice
        # nodes (the reference's per-node virtual dispatch) into one kernel.
        emitted = set()
        stages = []
        remaining = [n for n in topo if n is not dest]

        def upstream_ids(node):
            ids = set()
            for inp in node.inputs:
                for o in inp.connected_outputs:
                    ids.add(o.owner.node_id)
            for param in node.params.values():
                for o in param._mod_outputs:
                    ids.add(o.owner.node_id)
            return ids

        while remaining:
            ready = [n for n in remaining if upstream_ids(n) <= emitted]
            if not ready:  # cannot happen on a DAG, but fail loudly
                raise RuntimeError("stage scheduling stalled (cycle?)")
            by_key = {}
            singles = []
            for n in ready:
                key = n.group_key(node_in_counts[n.node_id])
                if key is None:
                    singles.append(n)
                else:
                    by_key.setdefault(key, []).append(n)
            for n in singles:
                stages.append(("single", [n], None))
            # Every keyed stage is a "group" even with one member: the state
            # layout, param encoding, and emitted program then depend only on
            # the key + lane count — never on node identity — which is what
            # lets structurally identical graphs share one compiled program.
            for key, nodes in by_key.items():
                stages.append(("group", nodes, key))
            for n in ready:
                emitted.add(n.node_id)
            remaining = [n for n in remaining if n.node_id not in emitted]
        stages.append(("dest", [dest], None))
        self.stages = stages
        self._fuse_chains()

        # Static kernel variants compiled into buffer-source stages; a
        # variant change (playbackRate scheduled beyond a compiled bound, a
        # constant rational rate edited, events added to a polyphase-compiled
        # param) forces a recompile.
        self.bufsrc_variants = {
            n.node_id: n.kernel_variant()
            for n in topo
            if _is_buffer_source(n) and n._buffer is not None
        }

        # State storage layout: grouped nodes live as ONE stacked pytree entry;
        # keys are STRUCTURAL ("st<i>" = stage position), so two graphs with
        # the same shape produce identical state pytrees and can share a
        # compiled program. Stacked group entries also keep the scan carry
        # small — per-node leaves made compile time scale linearly with voice
        # count. The context preserves state across recompiles by comparing
        # each key's member composition (``state_composition``) and migrating
        # surviving lanes individually when it changed.
        #
        # Group lane counts PAD to the next power of two with PHANTOM lanes
        # (fresh-init state -> scheduled sources stay gated off; zero inputs
        # -> linear kernels emit silence), so one-shot voice churn that only
        # changes the voice count within a bucket reuses the cached program
        # instead of recompiling.
        self.state_ref: Dict[int, Tuple[str, object]] = {}
        self.group_keys: Dict[int, str] = {}  # stage index -> state key
        self.state_composition: Dict[str, Tuple[int, ...]] = {}
        self.stage_pad: Dict[int, Tuple[int, int]] = {}  # si -> (real, padded)
        for si, (kind, nodes, _) in enumerate(self.stages):
            key = f"st{si}"
            self.state_composition[key] = tuple(n.node_id for n in nodes)
            if kind == "group":
                self.group_keys[si] = key
                self.stage_pad[si] = (len(nodes), _next_pow2(len(nodes)))
                for lane, n in enumerate(nodes):
                    self.state_ref[n.node_id] = (key, lane)
            elif kind == "pipe":
                # Pipe lanes are pipeline STAGES, not voices: no pow2
                # phantom padding (a phantom lane would change the delay).
                self.group_keys[si] = key
                self.stage_pad[si] = (len(nodes), len(nodes))
                for lane, n in enumerate(nodes):
                    self.state_ref[n.node_id] = (key, lane)
                # Register bank (in-flight audio between lanes) migrates by
                # composition like any group entry.
                self.state_composition[key + ".pipe"] = ("pipe",) + tuple(
                    n.node_id for n in nodes
                )
            else:
                self.state_ref[nodes[0].node_id] = (key, None)
        if self.pipe_delay:
            self.state_composition["__pipe_bt__"] = (
                "bt", self.pipe_delay, self.info.superblock,
            )

        # Param encoding capacities (pow2 padding keeps jit cache stable while
        # event lists grow). ALL params of a group share one capacity so the
        # step can STACK every param's encoding and evaluate a whole group's
        # automation in one batched pass (17 separate vmapped evaluations
        # dominated the spatial stage's dispatch count).
        for node in topo:
            for name, p in node.params.items():
                # Capacity 0 <=> statically event-free: the eval fast path
                # keys off the ZERO-length encoding shape, so the first
                # scheduled event (count 0 -> 1) changes argument shapes and
                # re-traces — staleness is impossible by construction.
                c = p.event_count()
                self.param_capacity[(node.node_id, name)] = (
                    _next_pow2(c) if c else 0
                )
        for kind, nodes, _ in self.stages:
            if kind in ("group", "pipe"):
                self._share_group_capacity(nodes)

        # ---- buffer-source arenas (traced constants) -----------------------
        # Source sample data travels as ARGUMENTS (one packed arena per
        # buffer-source stage, width padded to a pow2 bucket) rather than
        # closure constants, so a cached program replays with new buffers.
        self.consts: Dict[str, object] = {}
        self._bufsrc_cfg: Dict[int, Tuple[int, bool, int]] = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind != "group" or not _is_buffer_source(nodes[0]):
                continue
            rep = nodes[0]
            variant = rep.kernel_variant()  # shared: it's in the group key
            if variant[0] == "poly":
                w, front = type(rep).poly_window(
                    self.info.superblock, variant[1], variant[2]
                )
            elif variant[0] == "unity":
                w, front = type(rep)._window_w(self.info.superblock, 1, True), 0
            else:
                bound = max(n.rate_bound() for n in nodes)
                w, front = type(rep)._window_w(self.info.superblock, bound, False), 0
            built = [n.build_region(w, front) for n in nodes]
            regions = [b[0] for b in built]
            geoms = [b[1] for b in built]
            if variant[0] == "unity":
                # 128-align each voice's arena offset so the aligned variant's
                # row-gather fetch holds; harmless padding otherwise.
                regions = [
                    np.pad(r, ((0, 0), (0, (-r.shape[1]) % FRAMES_PER_BLOCK)))
                    for r in regions
                ]
            widths = [r.shape[1] for r in regions]
            offs = list(np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32))
            arena = np.concatenate(regions, axis=1)
            # Size the arena as if the phantom pad lanes had regions too, so
            # the padded width (a program-cache shape) is the same for every
            # real voice count within the bucket when assets repeat.
            real, padded = self.stage_pad[si]
            virtual_w = arena.shape[1] + (padded - real) * widths[0]
            # at least one 128-row: the group window fetch reshapes the
            # arena into [C, W/128, 128] rows
            arena_w = _next_pow2(max(virtual_w, w + 8, FRAMES_PER_BLOCK))
            if arena.shape[1] < arena_w:
                arena = np.pad(arena, ((0, 0), (0, arena_w - arena.shape[1])))
            # Phantom lanes duplicate lane 0's geometry: reads are valid data,
            # outputs are forced silent by the fresh (never-started) state.
            geoms = geoms + [geoms[0]] * (padded - real)
            offs = offs + [offs[0]] * (padded - real)
            stacked = {k: np.stack([g[k] for g in geoms]) for k in geoms[0]}
            stacked["off"] = np.asarray(offs, np.int32)
            self.consts[f"st{si}/arena"] = arena
            self.consts[f"st{si}/geom"] = stacked
            self._bufsrc_cfg[si] = (w, variant, arena_w)

        # ---- single-stage consts (e.g. convolver IR spectra) ----------------
        # Travelling as ARGUMENTS (not closure constants) lets a cached
        # program replay with a new IR, and gives the mesh path something to
        # shard (partition axes split over 'part').
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind != "single":
                continue
            sc = getattr(nodes[0], "stage_consts", None)
            if sc is None:
                continue
            for name, arr in sc(self.mesh).items():
                self.consts[f"st{si}/{name}"] = arr

        self._build_plan(node_in_counts)
        self._compute_sharding()

    # -- execution plan ---------------------------------------------------------
    #
    # The step function never reads live node objects' connection lists: all
    # routing is snapshotted here as plain data. That makes a compiled render
    # function safe to CACHE and to RE-TRACE later (jit retraces on new arg
    # shapes) even after the host graph that produced it has mutated.
    # Producers are addressed structurally as (stage, port, lane).

    def _fuse_chains(self) -> None:
        """Fuse head-to-tail runs of same-key 1-lane group stages into
        software-PIPELINED 'pipe' stages (systolic over superblocks).

        A cascade of K same-type nodes (the reference's serial EQ chain,
        BiQuadFilterNode.cs use) costs K sequential kernels per step here;
        on a latency-bound backend that is K x the scan-round latency. A
        pipe stage runs all K as ONE vmapped kernel per step by letting
        lane i process superblock (step - i): lane 0 takes the live input,
        lane i takes lane i-1's PREVIOUS-step output from a carried
        register [K-1, C, T]. Audio is identical — the graph's output is
        delayed by the total pipe depth D, which make_render_fn compensates
        by scanning D extra rows and dropping the first D outputs: a stage
        at level L is freeze-masked outside rows [L, n+L) (see commit() in
        make_step_fn), so the first D rows refill the pipeline and the last
        D rows drain it with state COMMITTED. Every lane processes every
        superblock exactly once, in the render call whose param encodings
        were live — param/topology edits between calls therefore behave
        exactly as the unfused graph.

        Every lane (and every stage downstream of a pipe) runs at a LEVEL:
        the number of superblocks between the live clock and the audio it
        processes. Param automation stays sample-exact because each stage
        evaluates its curves at the block clock of the step that produced
        its audio — a [D, S] ring of past block_times rides in the state.
        Fusion applies only when every stage's fan-in sits at ONE level
        (sources are always level 0, so a graph mixing a direct source tap
        with a chained path refuses fusion and renders unfused).
        """
        self.pipe_delay = 0
        self.stage_level = {}
        if not getattr(self.context, "pipeline_chains", False):
            return
        # Meshes compose with fusion: pipe lanes are pipeline STAGES, not
        # voices — pipe state (lanes, register bank, block-time ring)
        # REPLICATES across the mesh (make_render_fn's specs: only
        # sharded_stages keys shard, and pipes are never candidates), while
        # surrounding voice groups shard; a pipe fed by a sharded group's
        # whole-group fan-in completes with the same psum as any stage.
        stages = self.stages

        # -- find chains ------------------------------------------------------
        def fusable(entry):
            kind, nodes, key = entry
            if kind != "group" or len(nodes) != 1 or key is None:
                return False
            n = nodes[0]
            return (
                len(n.inputs) == 1
                and len(n.outputs) == 1
                and not _is_buffer_source(n)
                # Pipe lanes evaluate at per-lane clocks; a modulated param
                # would need the modulator's output at that lane's LEVEL,
                # which the register bank doesn't carry — modulated nodes
                # group (run_group stacks their mod signals) but don't fuse.
                and not n._params_modulated()
            )

        def links_to(a, b):
            """True when a's one output feeds EXACTLY b's one input."""
            out = a.outputs[0]
            return (
                len(out.connections) == 1
                and not out.param_connections
                and out.connections[0] is b.inputs[0]
                and len(b.inputs[0].connected_outputs) == 1
                and self.output_channels[(a.node_id, 0)]
                == self.output_channels[(b.node_id, 0)]
                and self.input_channels[(b.node_id, 0)]
                == self.output_channels[(a.node_id, 0)]
            )

        stage_idx_of = {}
        for si, (_k, nodes, _key) in enumerate(stages):
            for n in nodes:
                stage_idx_of[n.node_id] = si

        def chain_key_of(si):
            """Fusion-compatibility key: nodes may opt into fusing across
            differing group keys (the biquad drops its TYPE — the pipe
            kernel then selects coefficients per lane; see
            BiQuadFilterNode.chain_key). Default: the group key."""
            n = stages[si][1][0]
            fn = getattr(n, "chain_key", None)
            if fn is None:
                return stages[si][2]
            return fn([self.input_channels[(n.node_id, 0)]])

        used = set()
        chains = []  # list of [stage indices]
        for si, entry in enumerate(stages):
            if si in used or not fusable(entry):
                continue
            run = [si]
            cur = entry[1][0]
            while True:
                out = cur.outputs[0]
                if len(out.connections) != 1 or out.param_connections:
                    break
                nxt = out.connections[0].owner
                nsi = stage_idx_of.get(nxt.node_id)
                if (
                    nsi is None
                    or nsi in used
                    or not fusable(stages[nsi])
                    or chain_key_of(nsi) != chain_key_of(run[0])
                    or not links_to(cur, nxt)
                ):
                    break
                run.append(nsi)
                cur = nxt
            if len(run) >= 2:
                chains.append(run)
                used.update(run)

        if not chains:
            return

        # -- rebuild stages with fused pipes ----------------------------------
        head_of = {run[0]: run for run in chains}
        member = {si for run in chains for si in run[1:]}
        new_stages = []
        for si, entry in enumerate(stages):
            if si in member:
                continue
            if si in head_of:
                run = head_of[si]
                nodes = [stages[j][1][0] for j in run]
                new_stages.append(("pipe", nodes, entry[2]))
            else:
                new_stages.append(entry)

        # -- level assignment (mixed fan-in levels => abort) -------------------
        out_level = {}  # node_id -> producing level
        level = {}  # new stage index -> level the stage RUNS at
        for si, (kind, nodes, _key) in enumerate(new_stages):
            prods = set()
            ext_nodes = [nodes[0]] if kind == "pipe" else nodes
            for n in ext_nodes:
                for inp in n.inputs:
                    for o in inp.connected_outputs:
                        prods.add(o.owner.node_id)
                for p in n.params.values():
                    for o in p._mod_outputs:
                        prods.add(o.owner.node_id)
            in_levels = {out_level[nid] for nid in prods}
            if len(in_levels) > 1:
                return  # inconsistent fan-in alignment: render unfused
            lvl = in_levels.pop() if in_levels else 0
            level[si] = lvl
            out_lvl = lvl + (len(nodes) - 1 if kind == "pipe" else 0)
            for n in nodes:
                out_level[n.node_id] = out_lvl

        delay = level[len(new_stages) - 1]  # dest stage runs at the total delay
        if delay <= 0 or delay > 64:
            return
        self.stages = new_stages
        self.stage_level = level
        self.pipe_delay = delay

    def _build_plan(self, node_in_counts) -> None:
        stage_of = {}
        lane_of = {}
        stage_real = {}  # si -> real lane count for groups
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind in ("group", "pipe"):
                stage_real[si] = len(nodes)
            for lane, n in enumerate(nodes):
                stage_of[n.node_id] = si
                lane_of[n.node_id] = (
                    lane if kind in ("group", "pipe") else None
                )

        def producers(connected_outputs):
            prods = tuple(
                (
                    stage_of[o.owner.node_id],
                    o.index,
                    lane_of[o.owner.node_id],
                    self.output_channels[(o.owner.node_id, o.index)],
                )
                for o in connected_outputs
            )
            # Canonicalize "every lane of one group" fan-ins to a single
            # marker: the sum then runs over the PADDED tensor (phantom
            # lanes are silent), and the routing — hence the program
            # signature — no longer depends on the exact voice count.
            by_src: Dict[Tuple[int, int], list] = {}
            for p in prods:
                if p[2] is not None:
                    by_src.setdefault((p[0], p[1]), []).append(p)
            out = []
            consumed = set()
            for (psi, pport), ps in by_src.items():
                lanes = sorted(p[2] for p in ps)
                if lanes == list(range(stage_real.get(psi, -1))):
                    out.append(("ALL", psi, pport, ps[0][3]))
                    consumed.update(ps)
            for p in prods:
                if p not in consumed:
                    out.append(p)
            return tuple(out)

        def chain_or_lanes(nodes, getter, pad):
            """Group per-lane routing (audio inputs AND param modulation
            inputs): a pure 1:1 chain from one group canonicalizes to
            ("CHAIN", src_si, src_port) — count-independent when the source
            group pads to the same width. ``getter(n)`` yields the lane's
            connected outputs (an input port's or a param's modulators)."""
            per_lane = [
                tuple(
                    (
                        stage_of[o.owner.node_id],
                        o.index,
                        lane_of[o.owner.node_id],
                        self.output_channels[(o.owner.node_id, o.index)],
                    )
                    for o in getter(n)
                )
                for n in nodes
            ]
            first = per_lane[0]
            if (
                len(first) == 1
                and first[0][2] is not None
                and all(
                    len(pl) == 1
                    and pl[0][:2] == first[0][:2]
                    and pl[0][2] == v
                    for v, pl in enumerate(per_lane)
                )
            ):
                src_si = first[0][0]
                src_pad = self.stage_pad.get(src_si, (0, -1))[1]
                if src_pad == pad and stage_real.get(src_si) == len(nodes):
                    return ("CHAIN", src_si, first[0][1], first[0][3])
            # Fallback: explicit per-lane routing, phantom lanes silent.
            return tuple(
                producers(getter(n)) for n in nodes
            ) + ((),) * (pad - len(nodes))

        plan = []
        for si, (kind, nodes, gkey) in enumerate(self.stages):
            rep = nodes[0]
            if kind == "group":
                pad = self.stage_pad[si][1]
                inputs = tuple(
                    (
                        self.input_channels[(rep.node_id, i)],
                        chain_or_lanes(
                            nodes,
                            lambda n, i=i: n.inputs[i].connected_outputs,
                            pad,
                        ),
                    )
                    for i in range(len(rep.inputs))
                )
                # Group param spec: (name, a_rate, exact, modspec). modspec
                # is None for unmodulated params; for modulated ones (the
                # group_key's mod signature guarantees every lane agrees on
                # WHICH params are modulated) it carries the clamp range and
                # per-lane modulator routing — per-voice LFO -> param chains
                # batch exactly like per-voice audio inputs, with the 1:1
                # same-group case canonicalized to CHAIN (run_group applies
                # the stacked mono mod after the vmapped curve eval).
                params = tuple(
                    (
                        name,
                        p.automation_rate == AutomationRate.A_RATE,
                        p.exact_eval,
                        (
                            (
                                float(p.min_value),
                                float(p.max_value),
                                chain_or_lanes(
                                    nodes,
                                    lambda n, name=name:
                                    n.params[name]._mod_outputs,
                                    pad,
                                ),
                            )
                            if p._mod_outputs
                            else None
                        ),
                    )
                    for name, p in rep.params.items()
                )
            elif kind == "pipe":
                # External routing is the HEAD's input only; lanes 1..d-1
                # read the carried register bank. Pipe members never have
                # modulated params (fusable() excludes them).
                inputs = (
                    (
                        self.input_channels[(rep.node_id, 0)],
                        producers(rep.inputs[0].connected_outputs),
                    ),
                )
                params = tuple(
                    (name, p.automation_rate == AutomationRate.A_RATE,
                     p.exact_eval, None)
                    for name, p in rep.params.items()
                )
            else:
                inputs = tuple(
                    (
                        self.input_channels[(rep.node_id, inp.index)],
                        producers(inp.connected_outputs),
                    )
                    for inp in rep.inputs
                )
                params = tuple(
                    (
                        name,
                        p.automation_rate == AutomationRate.A_RATE,
                        float(p.min_value),
                        float(p.max_value),
                        producers(p._mod_outputs),
                        p.exact_eval,
                    )
                    for name, p in rep.params.items()
                )
            out_counts = tuple(
                self.output_channels.get((rep.node_id, i))
                for i in range(len(rep.outputs))
            )
            plan.append(
                {
                    "kind": kind,
                    "si": si,
                    "key": f"st{si}",
                    "rep": rep,
                    "n_lanes": (
                        self.stage_pad[si][1]
                        if kind in ("group", "pipe")
                        else 1
                    ),
                    "level": self.stage_level.get(si, 0),
                    "group_key": gkey,
                    # Pipes may chain nodes with DIFFERING group keys (e.g.
                    # mixed biquad types via chain_key); lane_keys joins the
                    # program-cache identity and tells run_pipe whether the
                    # kernel must read per-lane config selectors.
                    "lane_keys": (
                        tuple(
                            n.group_key(list(node_in_counts[n.node_id]))
                            for n in nodes
                        )
                        if kind == "pipe"
                        else None
                    ),
                    "inputs": inputs,
                    "params": params,
                    "out_counts": out_counts,
                    "bufsrc": self._bufsrc_cfg.get(si),
                }
            )
        self.plan = plan

    def _compute_sharding(self) -> None:
        """Decide PER STAGE whether its lane axis shards over the mesh.

        Candidates: groups whose padded lane count divides by the mesh's
        'voice' axis. Demotions (to replicated, computed identically on
        every device): any lane-indexed reference to the group's output
        (would need a cross-device gather), per-lane input routing (the plan
        enumerates GLOBAL lanes), and CHAIN endpoints with mismatched
        sharding — iterated to a fixpoint. Whole-group (ALL) fan-ins of a
        sharded group complete with a psum; of a replicated group, with a
        plain local sum.
        """
        self.sharded_stages = set()
        # Singles whose kernel distributes an internal axis over the mesh's
        # 'part' axis (e.g. the convolver's IR partitions): the node opts in
        # via supports_part_sharding(); its stage consts shard over 'part'
        # and the kernel completes with a psum (PartitionedConvolver.cs
        # :154-223's accumulation, distributed).
        self.part_sharded = set()
        if self.mesh is None:
            return
        if "part" in self.mesh.shape and int(self.mesh.shape["part"]) > 1:
            for sp in self.plan:
                if sp["kind"] == "single" and getattr(
                    sp["rep"], "supports_part_sharding", lambda m: False
                )(self.mesh):
                    self.part_sharded.add(sp["si"])
        n = int(self.mesh.shape["voice"])
        cand = {
            sp["si"]
            for sp in self.plan
            if sp["kind"] == "group" and sp["n_lanes"] % n == 0
        }

        changed = True
        while changed:
            changed = False

            def demote(si):
                nonlocal changed
                if si in cand:
                    cand.discard(si)
                    changed = True

            def scan_prods(prods):
                for p in prods:
                    if p[0] != "ALL" and p[2] is not None:
                        demote(p[0])

            for sp in self.plan:
                if sp["kind"] == "group":
                    routings = [r for _c, r in sp["inputs"]]
                    # Param modulation routes per lane exactly like inputs:
                    # CHAIN mods must shard consistently with their source;
                    # explicit per-lane mod routing demotes (global lanes).
                    routings.extend(
                        p[3][2] for p in sp["params"] if p[3] is not None
                    )
                    for routing in routings:
                        if routing and routing[0] == "CHAIN":
                            src = routing[1]
                            if (sp["si"] in cand) != (src in cand):
                                demote(sp["si"])
                                demote(src)
                        else:
                            if any(pl for pl in routing):
                                demote(sp["si"])
                            for pl in routing:
                                scan_prods(pl)
                else:
                    for _c, prods in sp["inputs"]:
                        scan_prods(prods)
                    for p in sp["params"]:
                        if len(p) == 6:  # single-stage spec with modulators
                            scan_prods(p[4])
        self.sharded_stages = cand

    def signature(self):
        """Structural identity of the emitted program.

        Two CompiledGraphs with equal signatures compute the same function of
        (states, encs, consts, feeds, frame0s) — the context keys its
        compiled-program cache on this, so voice churn (e.g. one-shot sounds
        re-creating structurally identical source+gain chains) reuses the
        already-jitted renderer instead of recompiling. Single (unbatched)
        stages key on node identity+config version (``static_fingerprint``)
        because their kernels may close over arbitrary instance data; group
        stages key on their batching key, which captures all kernel config.
        """
        mesh_id = None
        if self.mesh is not None:
            # Stable topology key (axis layout + physical device ids), not
            # id(mesh): object ids are recycled by the GC.
            mesh_id = (
                tuple(self.mesh.shape.items()),
                tuple(self.mesh.axis_names),
                tuple(d.id for d in self.mesh.devices.flat),
            )
        sig = [("hdr", self.info.sample_rate, self.info.superblock, mesh_id,
                self.pipe_delay)]
        for sp in self.plan:
            if sp["kind"] == "group":
                ident = ("G", sp["group_key"], sp["n_lanes"], sp["bufsrc"])
            elif sp["kind"] == "pipe":
                # lane_keys, not just the head's key: two pipes with the
                # same head but different member type sequences must not
                # alias one cached program.
                ident = ("P", sp["lane_keys"], sp["n_lanes"], sp["level"])
            elif sp["kind"] == "dest":
                ident = ("D",)
            else:
                ident = ("N", sp["rep"].static_fingerprint())
            sig.append((ident, sp["inputs"], sp["params"], sp["out_counts"]))
        return tuple(sig)

    def static_config_stale(self) -> bool:
        """True when a param-dependent static choice (a buffer source's
        compiled kernel variant) no longer matches the current param values."""
        for nid, compiled in self.bufsrc_variants.items():
            node = self.context._nodes.get(nid)
            if node is None:
                continue
            cur = node.kernel_variant()
            if cur == compiled:
                continue
            if (
                cur[0] == "resample"
                and compiled[0] == "resample"
                and cur[1] <= compiled[1]
            ):
                continue  # the compiled window bound still covers
            return True
        return False

    # -- state ------------------------------------------------------------------

    def _init_node_state(self, node) -> dict:
        st = node.init_state(self.info)
        overrides = getattr(node, "_state_overrides", None)
        if overrides:
            st = dict(st)
            for k, v in overrides.items():
                if k in st:
                    st[k] = np.asarray(v, dtype=np.asarray(st[k]).dtype)
        return st

    def init_states(self) -> Dict:
        states = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind in ("group", "pipe"):
                members = [self._init_node_state(n) for n in nodes]
                real, padded = self.stage_pad[si]
                # Phantom pad lanes: fresh init (never started -> silent).
                members += [
                    nodes[0].init_state(self.info) for _ in range(padded - real)
                ]
                states[f"st{si}"] = jax.tree_util.tree_map(
                    lambda *xs: np.stack([np.asarray(x) for x in xs]), *members
                )
                if kind == "pipe":
                    # In-flight audio between lanes; silent at stream start
                    # (lanes are linear, so warming up on silence is exact).
                    c = self.output_channels[(nodes[0].node_id, 0)]
                    states[f"st{si}.pipe"] = {
                        "reg": np.zeros(
                            (len(nodes) - 1, c, self.info.frames), np.float32
                        )
                    }
            else:
                states[f"st{si}"] = self._init_node_state(nodes[0])
        if self.pipe_delay:
            # Ring of the last D steps' block clocks (levels > 0 evaluate
            # automation at the clock of the step that produced their audio).
            states["__pipe_bt__"] = np.zeros(
                (self.pipe_delay, self.info.superblock), np.float64
            )
        # Upstream-only nodes feeding params etc. already appear in stages;
        # any topo node not staged (none today) would be initialized here.
        # Context-level globals (listener transform) travel in the state
        # pytree so they are data, not recompile triggers.
        states["__globals__"] = self.context.global_state()
        return states

    def _share_group_capacity(self, nodes) -> None:
        """Unify event capacities across a group's lanes, per param name.

        A name with events anywhere in the group takes the shared max
        capacity of all ever-automated names (so their [P, V, ...] encodings
        stack into one batched evaluation); a name that has NEVER had events
        on any lane stays at capacity 0 and rides the constant fast path
        (the batching key in run_group includes the capacity, so 0-cap names
        are never stacked with event-bearing ones).

        Capacities are a HIGH-WATER MARK: clearing a param's events (the
        ``value`` setter does) keeps its nonzero capacity, so the encoding
        shapes — and therefore the jitted renderer — stay stable through
        the common automate-then-set-value pattern. Shrinking to 0 would
        flip argument shapes and retrace (on the remote compile service,
        recompile) twice per round trip."""
        names = list(nodes[0].params)
        ever = {
            nm: (
                any(n.params[nm].event_count() > 0 for n in nodes)
                or any(
                    self.param_capacity[(n.node_id, nm)] > 0 for n in nodes
                )
            )
            for nm in names
        }
        cap = max(
            (self.param_capacity[(n.node_id, nm)]
             for n in nodes for nm in names if ever[nm]),
            default=0,
        )
        for n in nodes:
            for nm in names:
                self.param_capacity[(n.node_id, nm)] = cap if ever[nm] else 0

    def encode_params(self) -> Dict[str, dict]:
        """Encode all params' event lists; bumps capacities when outgrown.

        Grouped nodes' encodings stack into one [V, ...] entry per param so
        the step evaluates each group param with a single vmapped pass.
        """
        for node in self.topo:
            for name, p in node.params.items():
                key = (node.node_id, name)
                if p.event_count() > self.param_capacity[key]:
                    self.param_capacity[key] = _next_pow2(p.event_count())
        for kind, nodes, _ in self.stages:
            if kind in ("group", "pipe"):
                self._share_group_capacity(nodes)
        encs = {}
        for si, (kind, nodes, _) in enumerate(self.stages):
            if kind in ("group", "pipe"):
                real, padded = self.stage_pad[si]
                for name in nodes[0].params:
                    per = [
                        n.params[name].encode(
                            self.param_capacity[(n.node_id, name)]
                        )
                        for n in nodes
                    ]
                    # Phantom lanes duplicate lane 0's encoding — guaranteed
                    # finite values; outputs are silenced by state/input.
                    per += [per[0]] * (padded - real)
                    encs[f"st{si}/{name}"] = {
                        k: np.stack([e[k] for e in per]) for k in per[0]
                    }
            else:
                n = nodes[0]
                for name, p in n.params.items():
                    encs[f"st{si}/{name}"] = p.encode(
                        self.param_capacity[(n.node_id, name)]
                    )
        return encs

    # -- the step function ---------------------------------------------------

    def make_step_fn(self, stage_limit: int = None, axis_name: str = None,
                     part_axis: str = None):
        """Emit the pure step function from the snapshotted plan.

        The closure captures only the plan (immutable data) and each stage
        representative's kernel methods — never live connection lists — so
        the returned function stays correct if jit re-traces it after the
        host graph has been edited (the program cache relies on this).

        ``stage_limit`` (profiling aid; see benchmarks/ablate.py) truncates
        execution to the first N stages and returns the sum of every
        produced output as the step result, so XLA cannot dead-code-
        eliminate the work being timed.

        ``axis_name``: when running inside shard_map with group lanes
        sharded over that mesh axis, whole-group (ALL) fan-ins of stages in
        ``sharded_stages`` complete their local sums with a psum across the mesh.
        """
        sharded_stages = self.sharded_stages if axis_name else set()
        part_sharded = self.part_sharded if part_axis else set()
        info = self.info
        plan = self.plan if stage_limit is None else self.plan[:stage_limit]
        dest_channels = self.input_channels[(self.destination.node_id, 0)]

        pipe_delay = self.pipe_delay

        def step(states, encs, consts, feeds, frame0, block_times=None,
                 rowinfo=None):
            rc = RenderContext(info, frame0, block_times)
            rc.globals = states.get("__globals__")
            rc.feeds = feeds
            # out_table[(si, port)]: [C, T] for singles, stacked [V, C, T]
            # for groups; producers address lanes as (si, port, lane).
            out_table: Dict[Tuple[int, int], object] = {}
            new_states = {"__globals__": states.get("__globals__")}
            dest_out = None

            # Pipelined graphs: a stage at LEVEL l processes the audio of
            # superblock (step - l), so it must see the clock of that step —
            # row l-1 of the carried block-time ring (see _fuse_chains).
            bt_ring = states.get("__pipe_bt__") if pipe_delay else None
            rc_by_level = {0: rc}

            def rc_for(level):
                cached = rc_by_level.get(level)
                if cached is None:
                    cached = RenderContext(
                        info,
                        frame0 - jnp.int64(level * info.frames),
                        bt_ring[level - 1],
                    )
                    cached.globals = rc.globals
                    cached.feeds = rc.feeds
                    rc_by_level[level] = cached
                return cached

            if pipe_delay:
                new_states["__pipe_bt__"] = jnp.concatenate(
                    [rc.block_times[None], bt_ring[:-1]], axis=0
                ) if pipe_delay > 1 else rc.block_times[None]

            def commit(level, key, new):
                """Commit a stage's state update, freeze-masked when
                pipelining: at row ``r`` of a call scanning ``n`` main rows
                (+ D drain rows), a stage at level L is ACTIVE iff
                ``L <= r < n + L`` — it idles through its refill prologue
                (rows before its first new superblock reaches it) and after
                its drain completes. Every lane thus processes every
                superblock exactly ONCE, in the call whose param encodings
                were live, so inter-call edits behave exactly as unfused
                (the reference's semantics). Frozen stages still compute
                (junk) outputs, but those rows are only ever consumed by
                stages frozen at the same rows and are dropped from the
                delivered stream."""
                if rowinfo is None or not pipe_delay or level is None:
                    new_states[key] = new
                    return
                row, n_main = rowinfo
                act = jnp.logical_and(level <= row, row < n_main + level)
                new_states[key] = jax.tree_util.tree_map(
                    lambda nv, ov: jnp.where(act, nv, ov), new, states[key]
                )

            def mixed_signal(prods, dst_c):
                """Sum producer outputs into one [dst_c, T] block. Lanes of
                the same group tensor collapse into a single axis-0 reduction
                — the reference's fan-in summing junction
                (AudioNodeInput.cs:100-138) as one op. ("ALL", si, port, c)
                markers sum a group's whole padded tensor (phantom lanes are
                silent), keeping the program independent of the voice count."""
                direct = []
                lanes: Dict[Tuple[int, int], list] = {}
                parts = []
                for p in prods:
                    if p[0] == "ALL":
                        tensor = out_table[(p[1], p[2])]
                        summed = jnp.sum(tensor, axis=0)
                        if p[1] in sharded_stages:
                            # lanes live sharded over the mesh: the bus
                            # fan-in completes with a psum.
                            summed = jax.lax.psum(summed, axis_name)
                        parts.append(adapt_channels(summed, dst_c))
                        continue
                    psi, pport, plane, _c = p
                    if plane is None:
                        direct.append(out_table[(psi, pport)])
                    else:
                        lanes.setdefault((psi, pport), []).append(plane)
                parts.extend(adapt_channels(d, dst_c) for d in direct)
                for (psi, pport), vs in lanes.items():
                    tensor = out_table[(psi, pport)]
                    if len(vs) == tensor.shape[0]:
                        summed = jnp.sum(tensor, axis=0)
                    elif len(vs) == 1:
                        summed = tensor[vs[0]]
                    else:
                        summed = jnp.sum(tensor[jnp.asarray(vs)], axis=0)
                    parts.append(adapt_channels(summed, dst_c))
                if not parts:
                    return jnp.zeros((dst_c, rc.frames), dtype=jnp.float32)
                acc = parts[0]
                for p in parts[1:]:
                    acc = acc + p
                return acc

            def run_single(sp):
                si, key = sp["si"], sp["key"]
                src = rc_for(sp["level"])
                params = {}
                for name, a_rate, mn, mx, mods, exact in sp["params"]:
                    vals = eval_intrinsic_blocked(
                        encs[f"{key}/{name}"],
                        src.block_times,
                        FRAMES_PER_BLOCK if a_rate else 1,
                        src.dt,
                        exact=exact,
                    )
                    if mods:
                        # Hidden mono Explicit modulation input
                        # (AudioParam.cs:66-70); k-rate reads modulation at
                        # sample 0 of each block (AudioParam.cs:150-156).
                        mod = mixed_signal(mods, 1)[0]
                        m = (
                            mod
                            if a_rate
                            else mod.reshape(info.superblock, FRAMES_PER_BLOCK)[:, 0]
                        )
                        vals = jnp.clip(
                            vals + m, jnp.float32(mn), jnp.float32(mx)
                        )
                    params[name] = ParamSignal(vals, a_rate, info.superblock)
                inputs = [mixed_signal(prods, c) for c, prods in sp["inputs"]]
                # Per-stage consts + distribution context for kernels that
                # read IR spectra (etc.) as arguments / shard them.
                prefix = key + "/"
                src.stage_consts = {
                    n[len(prefix):]: consts[n]
                    for n in consts
                    if n.startswith(prefix)
                }
                src.part_axis = part_axis if si in part_sharded else None
                st, outs = sp["rep"].process(states[key], inputs, params, src)
                src.stage_consts = {}
                src.part_axis = None
                commit(sp["level"], key, st)
                for i, o in enumerate(outs):
                    out_table[(si, i)] = o

            def stacked_inputs(sp, inp_idx):
                """[V, C, T] inputs for a group: ("CHAIN", si, port) is the
                identity fast path (1:1 from an equally-padded group tensor);
                otherwise per-lane mixing, phantom pad lanes silent."""
                dst_c, routing = sp["inputs"][inp_idx]
                if routing and routing[0] == "CHAIN":
                    t = out_table[(routing[1], routing[2])]
                    if routing[3] != dst_c:
                        t = jax.vmap(lambda x: adapt_channels(x, dst_c))(t)
                    return t
                return jnp.stack(
                    [mixed_signal(pl, dst_c) for pl in routing], axis=0
                )

            def stacked_param_kinds(sp, key):
                """Group a stage's params into batched-eval kinds and stack
                their encodings: one vmapped evaluation per (rate,
                exactness, capacity) kind instead of P separate passes (17
                for the spatial panner, ~10 dispatches each). Capacity joins
                the batching key: 0-cap (statically event-free) names take
                the constant fast path and must not stack with event-bearing
                encodings. Yields ((a_rate, exact), names, stacked) plus the
                name->rate map."""
                by_kind: Dict[Tuple[bool, bool, int], list] = {}
                rates = {}
                for name, a_rate, exact, _modspec in sp["params"]:
                    cap_n = encs[f"{key}/{name}"]["times"].shape[-1]
                    by_kind.setdefault((a_rate, exact, cap_n), []).append(
                        name
                    )
                    rates[name] = a_rate
                kinds = []
                for (a_rate, exact, _cap), names in by_kind.items():
                    first = encs[f"{key}/{names[0]}"]
                    if len(names) == 1:
                        stacked = {
                            k: jnp.asarray(first[k])[None] for k in first
                        }
                    else:
                        stacked = {
                            k: jnp.stack(
                                [jnp.asarray(encs[f"{key}/{n}"][k])
                                 for n in names]
                            )
                            for k in first
                        }
                    kinds.append(((a_rate, exact), names, stacked))
                return kinds, rates

            def run_group(sp):
                si, key, rep = sp["si"], sp["key"], sp["rep"]
                src = rc_for(sp["level"])
                # States live stacked in the carry; params are pre-stacked
                # encodings evaluated with ONE vmapped pass per param.
                states_stacked = states[key]
                # The unity/poly buffer-source kernels consume NO params
                # (playbackRate is baked into the static variant) — skip the
                # vmapped curve evaluation entirely for them.
                wants_params = sp["bufsrc"] is None or sp["bufsrc"][1][0] == "resample"
                pvals = {}
                rates = {}
                if wants_params:
                    kinds, rates = stacked_param_kinds(sp, key)
                    for (a_rate, exact), names, stacked in kinds:
                        npb = FRAMES_PER_BLOCK if a_rate else 1
                        vals = jax.vmap(
                            jax.vmap(
                                lambda e, npb=npb, exact=exact:
                                eval_intrinsic_blocked(
                                    e, src.block_times, npb, src.dt,
                                    exact=exact,
                                )
                            )
                        )(stacked)  # [P, V, T or S]
                        for i, n in enumerate(names):
                            pvals[n] = vals[i]
                    # Modulated params: stack each lane's mixed mono
                    # modulation signal and add it to the intrinsic values —
                    # the hidden mono Explicit input (AudioParam.cs:66-70)
                    # vectorized over voices; k-rate reads the mod at sample
                    # 0 of each block (AudioParam.cs:150-156), and the sum
                    # clamps to the param's range exactly as run_single.
                    for name, a_rate, _exact, modspec in sp["params"]:
                        if modspec is None or name not in pvals:
                            continue
                        mn, mx, routing = modspec
                        if routing and routing[0] == "CHAIN":
                            t = out_table[(routing[1], routing[2])]  # [V,C,T]
                            mod = jax.vmap(
                                lambda x: adapt_channels(x, 1)
                            )(t)[:, 0]
                        else:
                            mod = jnp.stack(
                                [mixed_signal(pl, 1)[0] for pl in routing]
                            )
                        if not a_rate:
                            mod = mod.reshape(
                                mod.shape[0], info.superblock,
                                FRAMES_PER_BLOCK,
                            )[:, :, 0]
                        pvals[name] = jnp.clip(
                            pvals[name] + mod,
                            jnp.float32(mn), jnp.float32(mx),
                        )
                inputs_stacked = [
                    stacked_inputs(sp, i) for i in range(len(sp["inputs"]))
                ]

                if sp["bufsrc"] is not None:
                    w, variant, _ = sp["bufsrc"]
                    arena = jnp.asarray(consts[f"{key}/arena"])
                    geoms = consts[f"{key}/geom"]

                    if variant[0] == "poly":
                        # group-level kernels: element gathers replaced by
                        # row gathers + one-hot shift matmuls (see
                        # AudioBufferSourceNode.process_poly_group)
                        sts, outs = type(rep).process_poly_group(
                            states_stacked, arena, geoms, src, w,
                            variant[1], variant[2],
                        )
                        outs = [outs]
                    elif variant[0] == "unity":
                        sts, outs = type(rep).process_unity_group(
                            states_stacked, arena, geoms, src, w,
                            aligned=variant[1],
                        )
                        outs = [outs]
                    else:
                        # time-varying resample: pre-fetch all voice windows
                        # gather-free, vmap the interpolation lanes over them
                        starts = type(rep).resample_window_starts(
                            states_stacked, geoms, w
                        )
                        windows = type(rep)._gather_windows_group(
                            arena, starts, w
                        )

                        def lane(state, geom, pv, win):
                            return rep._process_resample(
                                state, arena, geom, pv["playbackRate"], src, w,
                                window=win,
                            )

                        sts, outs = jax.vmap(lane)(
                            states_stacked, geoms, pvals, windows
                        )
                else:

                    def lane(state, inputs, pv):
                        params = {
                            name: ParamSignal(v, rates[name], info.superblock)
                            for name, v in pv.items()
                        }
                        return rep.process(state, list(inputs), params, src)

                    sts, outs = jax.vmap(lane)(
                        states_stacked, tuple(inputs_stacked), pvals
                    )

                commit(sp["level"], key, sts)
                for i, o in enumerate(outs):  # o: [V, C, T]
                    out_table[(si, i)] = o

            def run_pipe(sp):
                """A fused chain, software-pipelined over superblocks: lane i
                processes superblock (step - base - i). One vmapped kernel
                replaces the chain's K sequential kernels; in-flight audio
                rides in a [K-1, C, T] register bank (see _fuse_chains)."""
                si, key, rep = sp["si"], sp["key"], sp["rep"]
                d = sp["n_lanes"]
                base = sp["level"]
                states_stacked = states[key]
                regs = states[key + ".pipe"]["reg"]

                # Per-lane clocks: lane i runs at level base + i.
                lane_f0 = frame0 - (
                    jnp.arange(d, dtype=jnp.int64) + base
                ) * jnp.int64(info.frames)
                lane_bts = jnp.stack([
                    rc_for(base + i).block_times for i in range(d)
                ])  # [d, S] f64

                # Group-style batched param eval, but each lane evaluates at
                # ITS OWN clock (the step that produced the audio it holds).
                pvals = {}
                kinds, rates = stacked_param_kinds(sp, key)
                for (a_rate, exact), names, stacked in kinds:
                    npb = FRAMES_PER_BLOCK if a_rate else 1
                    vals = jax.vmap(  # over P params
                        lambda e, npb=npb, exact=exact: jax.vmap(  # over lanes
                            lambda el, bt: eval_intrinsic_blocked(
                                el, bt, npb, rc.dt, exact=exact
                            )
                        )(e, lane_bts)
                    )(stacked)  # [P, d, T or S]
                    for i, n in enumerate(names):
                        pvals[n] = vals[i]

                # Lane 0 eats the live input; lane i eats lane i-1's
                # PREVIOUS-step output from the register bank.
                dst_c, routing = sp["inputs"][0]
                fresh = mixed_signal(routing, dst_c)
                lane_in = jnp.concatenate([fresh[None], regs], axis=0)

                # Lanes with differing group keys (mixed biquad types fused
                # via chain_key) read their config from per-lane state
                # selectors instead of rep's static attributes.
                mixed = len(set(sp["lane_keys"])) > 1

                def lane(state, inp, pv, f0, bt):
                    lrc = RenderContext(info, f0, bt)
                    lrc.globals = rc.globals
                    lrc.feeds = rc.feeds
                    lrc.mixed_config = mixed
                    params = {
                        name: ParamSignal(v, rates[name], info.superblock)
                        for name, v in pv.items()
                    }
                    return rep.process(state, [inp], params, lrc)

                sts, outs = jax.vmap(lane)(
                    states_stacked, lane_in, pvals, lane_f0, lane_bts
                )
                if rowinfo is None:
                    new_states[key] = sts
                else:
                    # Per-lane freeze window (see commit()): lane i runs at
                    # level base + i and is active iff base+i <= r < n+base+i.
                    # The windows of adjacent lanes are offset by exactly one
                    # row, so an active lane always reads a register written
                    # by an active producer the row before.
                    row, n_main = rowinfo
                    lvl = base + jnp.arange(d)
                    act = jnp.logical_and(lvl <= row, row < n_main + lvl)
                    new_states[key] = jax.tree_util.tree_map(
                        lambda nv, ov: jnp.where(
                            act.reshape((d,) + (1,) * (nv.ndim - 1)), nv, ov
                        ),
                        sts, states_stacked,
                    )
                # Registers are within-call scratch: rows written by frozen
                # lanes are only read by lanes frozen at the next row, and
                # after a call's drain no carried register is read again.
                new_states[key + ".pipe"] = {"reg": outs[0][:-1]}
                for i, o in enumerate(outs):
                    out_table[(si, i)] = o

            for sp in plan:
                if sp["kind"] == "single":
                    run_single(sp)
                elif sp["kind"] == "group":
                    run_group(sp)
                elif sp["kind"] == "pipe":
                    run_pipe(sp)
                else:  # destination: passthrough sink (AudioDestinationNode.cs:42-64)
                    dst_c, prods = sp["inputs"][0]
                    dest_out = mixed_signal(prods, dst_c)
                    new_states[sp["key"]] = states[sp["key"]]

            if dest_out is None:  # stage_limit probe: keep all work live
                dest_out = sum(jnp.sum(o) for o in out_table.values())
                for k in states:  # pass skipped stages' states through
                    if k not in new_states:
                        new_states[k] = states[k]
            return new_states, dest_out

        return step, dest_channels

    def make_render_fn(self):
        """Jitted multi-superblock renderer: scan step over frame offsets.

        This is the ONE compiled program per topology: wire-format int16
        delivery is a tiny shared jitted postprocess of its on-device output
        (``context._pack_int16``), never a second renderer.

        With a context mesh and a shardable plan, the WHOLE scan runs inside
        ``shard_map``: every group's lane axis is split over the mesh's
        'voice' axis (states, encodings, and source geometry sharded; the
        sample arena and single-node state replicated), voices mix locally,
        and each whole-group fan-in finishes with one psum across the mesh.
        """
        # Part-sharded singles engage shard_map even when no voice group
        # shards (e.g. a lone long-HRIR panner): otherwise part_sharded
        # would report a distribution that silently never ran.
        sharded = self.mesh is not None and bool(
            self.sharded_stages or self.part_sharded
        )
        self.render_sharded = sharded  # introspection: did shard_map engage
        step, dest_channels = self.make_step_fn(
            axis_name="voice" if sharded else None,
            part_axis="part" if sharded and self.part_sharded else None,
        )

        pipe_delay = self.pipe_delay

        def render(states, encs, consts, feeds, frame0s, block_times):
            if pipe_delay:
                # Pipelined graphs: the dest stream lags the live clock by
                # D superblocks. The caller hands D EXTRA rows of clocks;
                # one scan runs n+D rows with per-stage freeze masks (see
                # step's commit()): a stage at level L is active for rows
                # [L, n+L), so the first D rows refill the pipeline (junk
                # rows, dropped below) and the last D rows drain it with
                # state COMMITTED. Every lane processes every superblock
                # exactly once, in the call whose param encodings were
                # live — inter-call edits behave exactly as unfused.
                n = frame0s.shape[0] - pipe_delay
                rows = jnp.arange(frame0s.shape[0], dtype=jnp.int32)

                def body(carry, xs):
                    frame0, bt, row = xs
                    new_states, out = step(
                        carry, encs, consts, feeds, frame0, bt,
                        rowinfo=(row, n),
                    )
                    return new_states, out

                states, outs = jax.lax.scan(
                    body, states, (frame0s, block_times, rows)
                )
                # Valid dest superblocks are rows D..D+n-1 (works for any
                # n, including n < D).
                outs = outs[pipe_delay:]
            else:
                def body(carry, xs):
                    frame0, bt = xs
                    new_states, out = step(
                        carry, encs, consts, feeds, frame0, bt
                    )
                    return new_states, out

                states, outs = jax.lax.scan(
                    body, states, (frame0s, block_times)
                )
            # outs: [n_steps, C, T] -> [C, n_steps*T]
            outs = jnp.swapaxes(outs, 0, 1).reshape(outs.shape[1], -1)
            return states, outs

        if not sharded:
            return jax.jit(render, donate_argnums=(0,)), dest_channels

        from jax import shard_map
        from jax.sharding import PartitionSpec

        voice = PartitionSpec("voice")
        rep = PartitionSpec()
        sharded_keys = {f"st{si}" for si in self.sharded_stages}
        states_spec = {
            key: (voice if key in sharded_keys else rep)
            for key in self.state_composition
        }
        states_spec["__globals__"] = rep
        encs_spec = {}
        for sp in self.plan:
            for p in sp["params"]:
                encs_spec[f"{sp['key']}/{p[0]}"] = (
                    voice if sp["si"] in self.sharded_stages else rep
                )
        consts_spec = {}
        for si in self._bufsrc_cfg:
            consts_spec[f"st{si}/arena"] = rep
            consts_spec[f"st{si}/geom"] = (
                voice if si in self.sharded_stages else rep
            )
        rep_of = {sp["si"]: sp["rep"] for sp in self.plan}
        for name in self.consts:
            if name in consts_spec:
                continue
            si = int(name.split("/", 1)[0][2:])
            if si in self.part_sharded:
                # The stage const's partition axis splits over 'part'; the
                # node names it per const (convolver IR spectra [K, P2,
                # bins] -> axis 1, HRTF grid spectra [E, A, 2, P, B] ->
                # axis 3 via const_part_axes).
                local = name.split("/", 1)[1]
                axes = getattr(rep_of[si], "const_part_axes", {})
                ax = axes.get(local, 1)
                spec = [None] * np.ndim(self.consts[name])
                spec[ax] = "part"
                consts_spec[name] = PartitionSpec(*spec)
            else:
                consts_spec[name] = rep
        sharded_render = shard_map(
            render,
            mesh=self.mesh,
            in_specs=(states_spec, encs_spec, consts_spec, rep, rep, rep),
            out_specs=(states_spec, rep),
        )
        return jax.jit(sharded_render, donate_argnums=(0,)), dest_channels
