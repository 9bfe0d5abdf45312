"""Audio contexts: block clock, command queue, graph compilation, rendering.

``AudioContextBase`` mirrors GraphAudio.Core/AudioContextBase.cs: the block
clock (``current_time`` / ``current_block``), the destination node, the
cross-thread command queue (``post`` / ``execute_or_post``), and graph walking
(``get_all_nodes``). ``OfflineAudioContext`` mirrors
GraphAudio.Core/OfflineAudioContext.cs: synchronous rendering of N frames with
a partial-block carry cache.

Execution model: the context compiles its node graph (see
:mod:`graphaudio_tpu.core.graph`) into one jitted function over superblocks of
S render quanta and keeps all node state as a pytree on the device between
calls. Graph edits (connect/disconnect/param mutations) are applied at render
boundaries — the functional-state analogue of the reference's
render-thread-only mutation discipline (AudioContextBase.cs:266-305).
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphaudio_tpu.core.constants import (
    DEFAULT_SAMPLE_RATE,
    DEFAULT_SUPERBLOCK,
    FRAMES_PER_BLOCK,
)
from graphaudio_tpu.core.graph import CompiledGraph, StaticRenderInfo
from graphaudio_tpu.utils.profiling import RenderStats


@jax.jit
def _pack_int16(outs):
    """Device-side wire-format stage: [C, T] f32 audio -> flat interleaved
    int16 PCM. Applied as a tiny postprocess program to the f32 renderer's
    on-device output, so pcm16 delivery shares the ONE compiled renderer per
    topology (a dedicated pcm16 renderer would double the compiled-program
    count and its compile time). Quantization
    ``round(clip(x,-1,1)*32767)`` error is <= 0.5/32767 ~ 1.53e-5 full scale
    (the reference's device path is interleaved PCM, AudioContextBase.cs:88-161).
    """
    pcm = jnp.round(jnp.clip(outs, -1.0, 1.0) * jnp.float32(32767.0))
    return pcm.astype(jnp.int16).T.reshape(-1)


class AudioContextBase:
    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        superblock: int = DEFAULT_SUPERBLOCK,
        pipeline_chains: bool = False,
    ):
        if sample_rate <= 0:
            raise ValueError("sample_rate must be positive")
        if superblock <= 0:
            raise ValueError("superblock must be positive")
        self.sample_rate = int(sample_rate)
        self.superblock = int(superblock)
        # Software-pipeline head-to-tail chains of same-type nodes into one
        # vmapped stage per step (CompiledGraph._fuse_chains). Audio is
        # bit-identical per render call; the cost is D extra pipeline-drain
        # steps per call, so it defaults ON only for the offline context
        # (throughput renders) and OFF for block-at-a-time streaming.
        self.pipeline_chains = bool(pipeline_chains)
        self._nodes: Dict[int, object] = {}
        self._pending: deque = deque()
        self._timed: List = []  # (time, seq, command) — see post_at
        self._timed_seq = 0
        self._topology_version = 0
        self._compiled: Optional[CompiledGraph] = None
        self._compiled_version = -1
        self._render_fn = None
        self._dest_channels = None
        self._states = None
        self._consts = None
        # Structurally identical graphs (same signature()) reuse an
        # already-jitted renderer — voice churn (one-shot sounds) then costs
        # a host rebuild + state migration, not an XLA recompile.
        self._program_cache: "OrderedDict" = OrderedDict()
        self._param_versions: Dict = {}
        self._encs = None
        self._current_frame = 0  # host-side absolute frame counter
        # The reference's clock ACCUMULATES (`_currentTime = blockTime +
        # increment`, AudioContextBase.cs:77-78) rather than recomputing from
        # the frame index; automation event times routinely coincide with
        # sample instants, so replicating the exact rounding sequence is
        # required for sample-exact event boundaries.
        self._current_time = 0.0  # f64, accumulated in fl(128/sr) steps
        self._carry: Optional[np.ndarray] = None  # [C, n] leftover rendered frames
        self.mesh = None  # multi-chip voice sharding (set_mesh)
        # Launch-chunk schedule override (int, iterable of ints, or
        # "5,34"-style string); None defers to the GA_RENDER_CHUNK env var.
        # See _render_steps_launch.
        self.chunk_schedule = None
        self.stats = RenderStats()
        self._disposed = False
        self._disposing_callbacks: List[Callable] = []
        self._step_count = 0

        # Listener transform for spatialization. Right-handed basis with
        # ahead = -forward (parity: SteamAudioContext.SetListener, :136-164).
        self._listener = {
            "listener_pos": np.zeros(3, np.float32),
            "listener_right": np.array([1, 0, 0], np.float32),
            "listener_up": np.array([0, 1, 0], np.float32),
            "listener_ahead": np.array([0, 0, 1], np.float32),
        }

        # Context-level default HRIR set (parity: SteamAudioContext lazily
        # creates a default HRTF per context, SteamAudioContext.cs:82-106).
        # None = the analytic spherical-head+pinna model.
        self._default_hrir = None
        self._default_hrir_uid = 0

        # Destination created last so subclass attributes exist first.
        from graphaudio_tpu.nodes.destination import AudioDestinationNode

        self.destination = AudioDestinationNode(self)

    def set_default_hrir(self, source, n_azimuth=None, n_elevation=None,
                         length=None) -> None:
        """Install a measured HRIR set as this context's DEFAULT for every
        SpatialPannerNode that has no per-node override (parity: the
        reference gets phonon's built-in measured HRTF per context,
        SteamAudioContext.cs:82-106 — no public-domain measured set can be
        bundled in this build environment, so the default ships as the
        analytic model and upgrades to measured data with one call).

        ``source``: SOFA path, .npz path, or dict with ``hrir`` /
        ``azimuth_deg`` / ``elevation_deg`` / ``sample_rate`` (see
        ops/hrtf.load_hrir_grid). Pass None to revert to the analytic model.
        """
        if source is None:
            grid = None
        else:
            from graphaudio_tpu.ops.hrtf import (
                N_AZIMUTH, N_ELEVATION, load_hrir_grid,
            )

            grid = load_hrir_grid(
                source, self.sample_rate,
                n_azimuth=n_azimuth or N_AZIMUTH,
                n_elevation=n_elevation or N_ELEVATION,
                length=length,
            )

        def do(ctx):
            ctx._default_hrir = grid
            ctx._default_hrir_uid += 1
            # The grid is baked into panner kernels. Modulated panners compile
            # as SINGLE stages keyed by the node's static fingerprint (the
            # group key's ('ctx-default', uid) entry doesn't apply to them),
            # so every consumer of the context default must bump its own
            # config version — mirroring load_hrir — or the program cache
            # replays a kernel with the previous grid baked in.
            for node in ctx._nodes.values():
                if (
                    hasattr(node, "_custom_hrir")
                    and node._custom_hrir is None
                    and hasattr(node, "_config_changed")
                ):
                    node._config_changed()
            ctx._invalidate_topology()

        self.execute_or_post(do)

    def set_listener(self, position, forward, up) -> None:
        """Set the listener transform (parity: SteamAudioContext.SetListener).

        ``ahead = -forward`` mirrors the reference's phonon-convention basis;
        spatial panners consume it as data (no recompile on listener motion).
        """
        position = np.asarray(position, np.float32)
        forward = np.asarray(forward, np.float64)
        up = np.asarray(up, np.float64)
        f = forward / max(np.linalg.norm(forward), 1e-9)
        u = up / max(np.linalg.norm(up), 1e-9)
        right = np.cross(f, u)
        right /= max(np.linalg.norm(right), 1e-9)
        true_up = np.cross(right, f)
        listener = {
            "listener_pos": position,
            "listener_right": right.astype(np.float32),
            "listener_up": true_up.astype(np.float32),
            "listener_ahead": (-f).astype(np.float32),
        }

        def do(ctx):
            # Routed through the command queue (like set_default_hrir): a
            # direct write from a game thread races the realtime render
            # thread's `self._states = render_fn(self._states, ...)` rebind
            # and can land in the dict the render step is about to replace.
            ctx._listener = listener
            if ctx._states is not None and "__globals__" in ctx._states:
                ctx._states["__globals__"] = dict(listener)

        self.execute_or_post(do)

    def global_state(self) -> dict:
        return dict(self._listener)

    # -- clock (parity: AudioContextBase.cs:28,64-79,220-223) -----------------

    @property
    def current_time(self) -> float:
        """Current render time in seconds (accumulated double, parity:
        AudioContextBase.cs:28,77-78)."""
        return self._current_time

    @property
    def current_block(self) -> int:
        return self._current_frame // FRAMES_PER_BLOCK

    def frames_to_seconds(self, frames: int) -> float:
        return frames / self.sample_rate

    def seconds_to_frames(self, seconds: float) -> int:
        return int(seconds * self.sample_rate)

    # -- node registry ----------------------------------------------------------

    def _register_node(self, node) -> None:
        self._nodes[node.node_id] = node

    def _unregister_node(self, node) -> None:
        self._nodes.pop(node.node_id, None)
        self._invalidate_topology()

    def _invalidate_topology(self) -> None:
        self._topology_version += 1

    def get_all_nodes(self) -> List:
        """All nodes reachable from the destination (AudioContextBase.cs:191-218)."""
        seen = set()
        result = []
        stack = [self.destination]
        while stack:
            node = stack.pop()
            if node.node_id in seen:
                continue
            seen.add(node.node_id)
            result.append(node)
            for inp in node.inputs:
                for out in inp.connected_outputs:
                    if out.owner.node_id not in seen:
                        stack.append(out.owner)
            for param in node.params.values():
                for out in param._mod_outputs:
                    if out.owner.node_id not in seen:
                        stack.append(out.owner)
        return result

    # -- command queue (parity: AudioContextBase.cs:266-305) ------------------

    def post(self, command: Callable) -> None:
        """Enqueue a command to run at the next render boundary."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        self._pending.append(command)

    def execute_or_post(self, command: Callable) -> None:
        """Execute immediately when not mid-render, else enqueue.

        Host-driven contexts are never observed mid-render (rendering is a
        device-side scan), so this executes immediately; realtime contexts
        override to enqueue from non-render threads.
        """
        if self._disposed:
            raise RuntimeError("context is disposed")
        command(self)

    def post_at(self, time: float, command: Callable) -> None:
        """Enqueue a command to run when the block clock reaches ``time``.

        The reference drains its command queue at the start of EVERY
        128-frame block (AudioContextBase.cs:272-284), so cross-thread edits
        land with single-block granularity. Here rendering is a device-side
        scan over ``superblock`` blocks, so a timed command lands at the
        first not-yet-rendered superblock boundary whose block time is
        >= ``time``: ``render`` splits the call into segments at due
        boundaries and drains the queue between device launches. Granularity
        is therefore ``superblock`` blocks; a context built with
        ``superblock=1`` recovers the reference's exact per-block landing.

        Commands may edit params, start/stop sources, or rewire topology
        (a topology edit recompiles at the boundary; running voices keep
        their state via lane-wise migration). Frames already rendered —
        including frames sitting in the host carry after a non-aligned
        ``render`` — are never affected. Timed commands are host callables
        and are NOT captured by checkpoint/resume.
        """
        if self._disposed:
            raise RuntimeError("context is disposed")
        self._timed.append((float(time), self._timed_seq, command))
        self._timed_seq += 1

    def _drain_due_timed(self) -> None:
        """Move timed commands due at the current block clock into the
        ordinary pending queue (in (time, post-order) order)."""
        if not self._timed:
            return
        # Swap-then-partition so a concurrent post_at from another thread
        # (realtime contexts) lands either in the snapshot or in the fresh
        # list — never lost. Only the render thread drains.
        snap, self._timed = self._timed, []
        due = []
        keep = []
        for e in snap:
            (due if e[0] <= self._current_time else keep).append(e)
        self._timed.extend(keep)
        due.sort()
        for _, _, cmd in due:
            self._pending.append(cmd)

    def _timed_steps_until_next(self, max_steps: int) -> Optional[int]:
        """Superblock steps from the current clock until the first pending
        timed command's landing boundary, or None if none lands within
        ``max_steps``. Replicates the launch-side accumulated clock
        (``t[k+1] = fl(t[k] + fl(128/sr))``) so the boundary chosen here is
        bit-identical to the segment start time the device will see."""
        if not self._timed:
            return None
        t_next = min(self._timed)[0]
        if self._current_time >= t_next:
            return 0
        n_blocks = max_steps * self.superblock
        inc = np.float64(FRAMES_PER_BLOCK) / self.sample_rate
        arr = np.full(n_blocks, inc)
        arr[0] = self._current_time
        times = np.add.accumulate(arr)  # times[i] = start time of block i
        # Boundary j (start of step j) has time times[j*S] for j in
        # [1, max_steps); the boundary after the final step is past range.
        for j in range(1, max_steps):
            if times[j * self.superblock] >= t_next:
                return j
        return None

    def _segment_cap(self, n_steps: int) -> int:
        """Steps the next render segment may run before a timed command must
        land: commands due NOW move to the pending queue (the segment launch
        drains them), and the segment is capped at the first still-future
        command's landing boundary."""
        k = self._timed_steps_until_next(n_steps)
        if k == 0:
            self._drain_due_timed()
            k = self._timed_steps_until_next(n_steps)
        return k if k else n_steps

    def _drain_commands(self) -> None:
        self._drain_due_timed()
        while self._pending:
            cmd = self._pending.popleft()
            try:
                cmd(self)
            except Exception:
                # Parity: the reference swallows command exceptions during
                # drain (AudioContextBase.cs:276-283).
                pass

    # -- compilation & state management ------------------------------------------

    @property
    def static_info(self) -> StaticRenderInfo:
        return StaticRenderInfo(self.sample_rate, self.superblock)

    def set_mesh(self, mesh) -> None:
        """Shard voice groups across a device mesh for multi-chip rendering.

        ``mesh`` must carry a 'voice' axis with a power-of-two size (group
        lanes pad to it). Graphs whose routing is per-voice chains plus
        whole-group bus fan-ins (the standard voice-scene shape) run inside
        ``shard_map`` with one psum per fan-in; other topologies fall back
        to single-device execution automatically. Pass None to unshard.
        """
        if mesh is not None:
            if "voice" not in mesh.shape:
                raise ValueError("mesh must have a 'voice' axis")
            n = int(mesh.shape["voice"])
            if n & (n - 1):
                raise ValueError("'voice' axis size must be a power of two")
        self.mesh = mesh
        self._program_cache.clear()
        self._invalidate_topology()

    def _ensure_compiled(self) -> None:
        if self._compiled is not None and self._compiled_version == self._topology_version:
            return
        old_states = self._states
        self._compiled = CompiledGraph(self)
        self._compiled_version = self._topology_version
        self._compiled_sig = self._compiled.signature()
        self._render_fn, self._dest_channels = self._get_render_fn()
        # Arenas/geometry are device-resident arguments (not closure
        # constants) so a cache hit replays with the new graph's buffers.
        self._consts = jax.tree_util.tree_map(
            jax.device_put, self._compiled.consts
        )
        # init_states applies each node's host-side overrides (e.g. start()
        # called before connect()); then preserve surviving entries — group
        # entries are keyed by their exact member composition, so a preserved
        # entry is always shape- and meaning-compatible. When a group's
        # membership changed, surviving lanes migrate individually so running
        # voices keep their playback/filter state (parity: state lives on the
        # node in the reference).
        old_ref = getattr(self, "_old_state_ref", {})
        old_comp = getattr(self, "_old_state_composition", {})
        new_comp = self._compiled.state_composition
        new_states = self._compiled.init_states()
        if old_states:
            old_host_cache = {}

            def old_node_state(nid):
                """Host copy of one node's previous state, or None."""
                src = old_ref.get(nid)
                if src is None or src[0] not in old_states:
                    return None
                key, lane = src
                if key not in old_host_cache:
                    old_host_cache[key] = jax.device_get(old_states[key])
                entry = old_host_cache[key]
                if lane is None:
                    return entry
                return {k: np.asarray(v)[lane] for k, v in entry.items()}

            def compatible(a, b):
                return set(a) == set(b) and all(
                    np.shape(a[k]) == np.shape(b[k])
                    and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
                    for k in a
                )

            for key, st in list(new_states.items()):
                if key == "__globals__":
                    continue
                if not isinstance(st, dict):
                    # Bare-array entries (the pipeline block-time ring):
                    # whole-entry reuse only, no per-lane migration.
                    if (
                        key in old_states
                        and old_comp.get(key) == new_comp.get(key)
                        and _same_structure(old_states[key], st)
                    ):
                        new_states[key] = old_states[key]
                    continue
                # Whole-entry reuse requires the SAME member composition:
                # state keys are structural ("st<i>"), so an equal-shaped
                # entry may belong to different nodes after voice churn.
                if (
                    key in old_states
                    and old_comp.get(key) == new_comp.get(key)
                    and _same_structure(old_states[key], st)
                ):
                    new_states[key] = old_states[key]
                    continue
                # Lane-wise migration: surviving voices keep their playback /
                # filter state even when their stage's composition changed.
                members = [
                    (nid, ref[1])
                    for nid, ref in self._compiled.state_ref.items()
                    if ref[0] == key
                ]
                rebuilt = {k: np.asarray(v).copy() for k, v in st.items()}
                migrated = False
                for nid, lane in members:
                    src_state = old_node_state(nid)
                    if src_state is None:
                        continue
                    proto = (
                        rebuilt
                        if lane is None
                        else {k: v[lane] for k, v in rebuilt.items()}
                    )
                    if not compatible(src_state, proto):
                        continue
                    migrated = True
                    if lane is None:
                        rebuilt = {
                            k: np.asarray(src_state[k]).copy() for k in rebuilt
                        }
                    else:
                        for k in rebuilt:
                            rebuilt[k][lane] = np.asarray(src_state[k])
                if migrated:
                    new_states[key] = rebuilt
        self._states = new_states
        # Config-derived leaves (e.g. the biquad's type selector) must
        # reflect the node's CURRENT config: migration above preserves
        # running state wholesale, which would carry a stale selector
        # across a config edit. Re-derive only CHANGED ones — each
        # update_node_state materializes the node's (possibly device-
        # resident) state entry, so rewriting K already-correct selectors
        # would cost K host syncs per recompile.
        cfg_cache = getattr(self, "_config_state_cache", {})
        self._config_state_cache = {}
        for nid, ref in self._compiled.state_ref.items():
            node = self._nodes.get(nid)
            cfg = getattr(node, "config_state", None)
            if cfg is None:
                continue
            leaves = cfg()
            self._config_state_cache[nid] = leaves
            prev = cfg_cache.get(nid)
            if prev is not None and all(
                np.array_equal(prev.get(k), v) for k, v in leaves.items()
            ):
                continue  # unchanged config; migrated value is correct
            self.update_node_state(node, **leaves)
        self._old_state_ref = dict(self._compiled.state_ref)
        self._old_state_composition = dict(new_comp)
        self._encs = None  # force re-encode against (possibly) new capacities
        self._param_versions = {}

    def _get_render_fn(self):
        """Fetch (or build) the ONE jitted renderer per topology.

        The program cache keys on the structural signature; structurally
        identical graphs reuse the program across voice churn. Wire-format
        PCM delivery is a shared jitted postprocess of this renderer's
        on-device output (``_pack_int16``), not a second program."""
        key = self._compiled_sig
        cached = self._program_cache.get(key)
        if cached is not None:
            self._program_cache.move_to_end(key)
            self.stats.record_program_reuse()
            return cached
        self.stats.record_compile()
        fn, dest_channels = self._compiled.make_render_fn()
        self._program_cache[key] = (fn, dest_channels)
        while len(self._program_cache) > 8:
            self._program_cache.popitem(last=False)
        return fn, dest_channels

    def _ensure_params_encoded(self) -> None:
        dirty = self._encs is None
        if not dirty:
            for node in self._compiled.topo:
                for name, p in node.params.items():
                    if self._param_versions.get((node.node_id, name)) != p.version:
                        dirty = True
                        break
                if dirty:
                    break
        if dirty:
            # device-resident so repeated render calls don't re-upload
            self._encs = jax.tree_util.tree_map(
                jax.device_put, self._compiled.encode_params()
            )
            for node in self._compiled.topo:
                for name, p in node.params.items():
                    self._param_versions[(node.node_id, name)] = p.version

    def update_node_state(self, node, **updates) -> None:
        """Replace leaves of a node's carried state (host command helper).

        Used by scheduled-source commands (start/stop) to write their
        schedule into the functional state between render steps. Updates are
        also recorded on the node so they survive (re)compilation — a source
        may be scheduled before it is connected into the graph.
        """
        if not hasattr(node, "_state_overrides"):
            node._state_overrides = {}
        node._state_overrides.update(updates)
        if self._states is None or self._compiled is None:
            return
        ref = self._compiled.state_ref.get(node.node_id)
        if ref is None or ref[0] not in self._states:
            return
        key, lane = ref
        st = dict(self._states[key])
        for k, v in updates.items():
            if k not in st:
                continue
            if lane is None:
                st[k] = np.asarray(v, dtype=np.asarray(st[k]).dtype)
            else:
                arr = np.asarray(st[k]).copy()
                arr[lane] = v
                st[k] = arr
        self._states[key] = st

    def peek_node_state(self, node) -> Optional[dict]:
        """Host view of a node's current state (device_get; for debugging/events)."""
        if self._states is None or self._compiled is None:
            return None
        ref = self._compiled.state_ref.get(node.node_id)
        if ref is None or ref[0] not in self._states:
            return None
        entry = jax.device_get(self._states[ref[0]])
        if ref[1] is None:
            return entry
        return {k: np.asarray(v)[ref[1]] for k, v in entry.items()}

    # -- rendering ------------------------------------------------------------

    def _render_steps_launch(self, n_steps: int, pack: str = None):
        """Drain commands, compile if needed, and LAUNCH ``n_steps``
        superblocks on device; returns an opaque pending handle.

        Splitting launch from ``_render_steps_finish`` lets callers pipeline
        device latency: the realtime render thread launches step n+1 before
        materializing step n's audio, hiding one host-device round trip per
        step.
        """
        if self._disposed:
            raise RuntimeError("context is disposed")
        import time as _time

        t0 = _time.perf_counter()
        self._drain_commands()
        self._ensure_compiled()
        if self._compiled.static_config_stale():
            self._invalidate_topology()
            self._ensure_compiled()
        self._ensure_params_encoded()

        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        total_frames = n_steps * frames_per_step
        # Host-streamed data (decoder-fed source nodes) staged per render call
        # (the device analogue of the reference's decoder-thread buffer queue,
        # AudioDecoderStreamNode.cs:47-87).
        feeds = {}
        for node in self._compiled.topo:
            if hasattr(node, "prepare_feed"):
                feeds[str(node.node_id)] = node.prepare_feed(total_frames)
        if feeds:
            # Feed arrays are indexed relative to this call's first frame.
            feeds["__base__"] = np.int64(self._current_frame)
        # Pipeline compute with device->host transfer: launch the next chunk's
        # scan before materializing the previous chunk's audio.
        # Block clock for the whole launch, accumulated with the reference's
        # exact rounding sequence: t[k+1] = fl(t[k] + fl(128/sr))
        # (AudioContextBase.cs:77-78). np.add.accumulate folds left-to-right
        # with intermediate rounding, replicating it bit-for-bit.
        # Pipelined graphs scan D extra drain rows per render call (stage
        # states commit under per-level freeze masks; see graph.py commit());
        # the extra rows continue the accumulated clock past the call's end.
        pipe_d = getattr(self._compiled, "pipe_delay", 0)
        n_blocks = (n_steps + pipe_d) * self.superblock
        inc_arr = np.full(n_blocks, np.float64(FRAMES_PER_BLOCK) / self.sample_rate)
        inc_arr[0] = self._current_time
        all_block_times = np.add.accumulate(inc_arr).reshape(
            n_steps + pipe_d, self.superblock
        )
        import os as _os

        # superblocks per pipelined launch: smaller chunks start their
        # device->host copies sooner, larger ones need fewer dispatches. A
        # comma-separated schedule ("5,34") sizes the leading chunks
        # individually (the last entry repeats): a small HEAD chunk starts
        # its copy as soon as its compute lands instead of after a full
        # chunk's. Each distinct size is one compiled scan length, so
        # schedules should reuse few sizes. ``ctx.chunk_schedule`` (an int,
        # list of ints, or "5,34"-style string) overrides the env.
        override = getattr(self, "chunk_schedule", None)
        if override is not None:
            if isinstance(override, int):
                raw = str(override)
            elif isinstance(override, str):
                raw = override
            else:  # iterable of ints
                try:
                    raw = ",".join(str(int(c)) for c in override)
                except (TypeError, ValueError):
                    raise ValueError(
                        "chunk_schedule must be an int, a comma-separated "
                        "string, or an iterable of positive integers; got "
                        f"{override!r}"
                    ) from None
                # Materialize one-shot iterables (a generator would be
                # exhausted by this join and break the NEXT render call).
                self.chunk_schedule = raw
        else:
            raw = _os.environ.get("GA_RENDER_CHUNK", "64")
        try:
            sched = [int(c.strip()) for c in raw.split(",")]
        except ValueError:
            src = "chunk_schedule" if override is not None else "GA_RENDER_CHUNK"
            raise ValueError(
                f"{src} must be a comma-separated list of positive "
                f"integers (e.g. '5,34'), got {raw!r}"
            ) from None
        if any(c <= 0 for c in sched):
            src = "chunk_schedule" if override is not None else "GA_RENDER_CHUNK"
            raise ValueError(
                f"{src} entries must be positive, got {sched}"
            )
        render_fn = self._render_fn
        if pack == "int16":
            pack_fn = _pack_int16
        elif pack == "mulaw":
            from graphaudio_tpu.ops.wire import pack_mulaw

            pack_fn = pack_mulaw
        elif pack is not None:  # ImaDeviceStream: stateful, chunk -> (blocks, n)
            pack_fn = pack.encode_chunk
        else:
            pack_fn = None
        t_prep = _time.perf_counter() - t0
        pending = []
        chunk_dispatch_s = []
        launched = 0
        chunk_i = 0  # schedule position (decoupled from the stats list)
        while launched < n_steps:
            this = min(sched[min(chunk_i, len(sched) - 1)], n_steps - launched)
            chunk_i += 1
            frame0s = (
                self._current_frame
                + frames_per_step
                * (launched + np.arange(this + pipe_d, dtype=np.int64))
            )
            t_d = _time.perf_counter()
            self._states, out = render_fn(
                self._states, self._encs, self._consts, feeds, frame0s,
                all_block_times[launched:launched + this + pipe_d],
            )
            if pack_fn is not None:
                out = pack_fn(out)
            # Start this chunk's device->host copy NOW, before dispatching
            # the next chunk: the device queue is in-order, so a copy
            # enqueued here sits behind only THIS chunk's compute — deferred
            # to after the dispatch loop it would queue behind EVERY
            # chunk's compute and no byte would move until the whole launch
            # drained. Finish-side gets collect the copies.
            arr = out[0] if isinstance(out, tuple) else out
            try:
                arr.copy_to_host_async()
            except AttributeError:  # non-arrays under shard_map probes
                pass
            chunk_dispatch_s.append(_time.perf_counter() - t_d)
            pending.append(out)
            launched += this
        t_c = _time.perf_counter()
        # Prefetch the stop-time leaves the finish-side notification will
        # read, so its device_get is served from the in-flight copy instead
        # of paying a fresh round trip.
        _, fetch = self._notify_refs()
        for arr in fetch.values():
            try:
                arr.copy_to_host_async()
            except AttributeError:
                pass
        copy_start_s = _time.perf_counter() - t_c
        self._current_frame += n_steps * frames_per_step
        self._current_time = float(
            all_block_times[n_steps - 1, -1]
            + np.float64(FRAMES_PER_BLOCK) / self.sample_rate
        )
        self._step_count += n_steps
        breakdown = {
            "prep_s": t_prep,
            "dispatch_s": sum(chunk_dispatch_s),
            "chunk_dispatch_s": chunk_dispatch_s,
            "copy_start_s": copy_start_s,
            "n_chunks": len(pending),
        }
        return pending, _time.perf_counter() - t0, pack, breakdown, total_frames

    def _render_steps_finish(self, handle) -> np.ndarray:
        """Materialize a launch's audio, fire source notifications, record
        stats. Handles must finish in launch order. Recorded wall time is
        launch work + finish work (idle time between the two, e.g. while a
        pipelined caller overlaps other steps, is excluded)."""
        import time as _time

        pending, launch_wall, pack, breakdown, frames = handle
        t0 = _time.perf_counter()
        # pcm16/mulaw chunks are flat interleaved (axis 0); ima chunks are
        # [block, block_align] byte rows (axis 0, trimmed to the kept block
        # count recorded at launch); f32 chunks are [C, T] (axis 1).
        chunk_transfer_s = []
        parts = []
        for o in pending:
            t_x = _time.perf_counter()
            if isinstance(o, tuple):  # (ima block slots, kept count)
                blocks, nblk = o
                parts.append(np.asarray(jax.device_get(blocks))[:nblk])
            else:
                parts.append(np.asarray(jax.device_get(o)))
            chunk_transfer_s.append(_time.perf_counter() - t_x)
        axis = 1 if pack is None else 0
        out_np = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=axis)
        t_n = _time.perf_counter()
        transfer_s = t_n - t0
        self._notify_sources()
        notify_s = _time.perf_counter() - t_n
        breakdown.update(
            transfer_s=transfer_s,
            chunk_transfer_s=chunk_transfer_s,
            notify_s=notify_s,
        )
        self.stats.record(
            frames=frames,
            quanta=frames // FRAMES_PER_BLOCK,
            wall=launch_wall + (_time.perf_counter() - t0),
            breakdown=breakdown,
        )
        return out_np

    def _render_steps(self, n_steps: int, pack: str = None) -> np.ndarray:
        """Render ``n_steps`` superblocks; returns f32[channels, n_steps*S*128]
        (or flat interleaved int16 with ``pack="int16"``).

        Drains pending commands first (parity: DrainCommands at block start,
        AudioContextBase.cs:272), then runs the jitted scan on device.
        """
        return self._render_steps_finish(self._render_steps_launch(n_steps, pack))

    def _notify_refs(self):
        """Scheduled sources that could actually end, with their stop-time
        arrays. A source that never started, already raised ended, or can
        neither hit a finite scheduled stop nor self-stop on the device
        (looping / unstopped sources) is skipped ENTIRELY — the common
        all-voices-looping scene then renders with zero notification
        round trips."""
        wanted = []
        fetch = {}
        for node in self._compiled.topo:
            if not getattr(node, "wants_notify", False):
                continue
            if not getattr(node, "may_notify", lambda: True)():
                continue
            ref = self._compiled.state_ref.get(node.node_id)
            if ref is None or ref[0] not in self._states:
                continue
            entry = self._states[ref[0]]
            if "stop_time" not in entry:
                continue
            wanted.append((node, ref))
            fetch.setdefault(ref[0], entry["stop_time"])
        return wanted, fetch

    def _notify_sources(self) -> None:
        """Fire ended-events / self-disposal on scheduled sources.

        All wanted state leaves transfer in ONE device_get, not one round
        trip per node.
        """
        end_time = self.current_time
        wanted, fetch = self._notify_refs()
        if not wanted:
            return
        batch = jax.device_get(fetch)  # one transfer for all sources
        for node, (key, lane) in wanted:
            st = batch[key] if lane is None else np.asarray(batch[key])[lane]
            node.notify_rendered({"stop_time": st}, end_time)

    # -- lifecycle ------------------------------------------------------------

    def on_disposing(self, callback: Callable) -> None:
        """Parity: AudioContextBase.Disposing event (:241)."""
        self._disposing_callbacks.append(callback)

    def dispose(self) -> None:
        if self._disposed:
            return
        for cb in self._disposing_callbacks:
            try:
                cb()
            except Exception:
                pass
        self.destination.dispose()
        self._disposed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.dispose()
        return False

    # -- block-level APIs (parity: AudioContextBase.cs:52-186) -----------------
    #
    # ``render`` lives on the BASE context: every context can pull frames
    # synchronously (the reference's ProcessBlock family is likewise defined
    # on AudioContextBase and works for any concrete context). Rendering
    # happens in superblocks; excess frames are carried in a host-side cache
    # and served first on the next call, mirroring the reference's
    # partial-block carry (OfflineAudioContext.cs:55-101).

    def process_block(self) -> np.ndarray:
        """Render exactly one 128-frame quantum -> f32[channels, 128]
        (parity: ProcessBlock, AudioContextBase.cs:52-81)."""
        return self.render(FRAMES_PER_BLOCK)

    def process_block_interleaved(self) -> np.ndarray:
        """One quantum, interleaved f32[128*channels]
        (parity: ProcessBlockInterleaved, AudioContextBase.cs:88-161)."""
        out = self.render(FRAMES_PER_BLOCK)
        return np.ascontiguousarray(out.T).reshape(-1)

    def process_blocks(self, block_count: int) -> np.ndarray:
        """Render ``block_count`` quanta -> f32[channels, block_count*128]
        (parity: ProcessBlocks, AudioContextBase.cs:166-186)."""
        return self.render(block_count * FRAMES_PER_BLOCK)

    def render(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames; returns f32[channels, frame_count]."""
        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        if frame_count == 0:
            ch = self._carry.shape[0] if self._carry is not None else 2
            return np.zeros((ch, 0), dtype=np.float32)

        chunks = []
        got = 0

        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            chunks.append(self._carry[:, :take])
            self._carry = self._carry[:, take:] if take < self._carry.shape[1] else None
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            # Timed commands (post_at) land at superblock boundaries: cap
            # the segment at the next landing boundary, drain there, go on.
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            out = self._render_steps(n_steps)
            if out.shape[1] > remaining:
                self._carry = out[:, remaining:].copy()
                out = out[:, :remaining]
            chunks.append(out)
            remaining -= out.shape[1]

        if len(chunks) == 1:
            return np.ascontiguousarray(chunks[0])
        # Channel counts can differ between carried audio and a recompiled
        # graph; pad to the widest (rare; only after topology edits).
        width = max(c.shape[0] for c in chunks)
        padded = []
        for c in chunks:
            if c.shape[0] < width:
                c = np.vstack([c, np.zeros((width - c.shape[0], c.shape[1]), np.float32)])
            padded.append(c)
        return np.concatenate(padded, axis=1)

    def render_interleaved(self, frame_count: int) -> np.ndarray:
        """Render and interleave -> f32[frame_count*channels]
        (parity: the interleaving of ProcessBlockInterleaved applied to an
        arbitrary frame count)."""
        out = self.render(frame_count)
        return np.ascontiguousarray(out.T).reshape(-1)

    def render_pcm16(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames as interleaved int16 PCM.

        The interleave and the quantization ``round(clip(x, -1, 1) * 32767)``
        run ON DEVICE, so only 2 bytes/sample cross to the host — the
        natural wire format for PCM delivery (the reference's device path is
        interleaved PCM as well, AudioContextBase.cs:88-161). Quantization
        error is at most 0.5/32767 ~ 1.53e-5 of full scale.

        Returns int16[frame_count * channels]. Interleaving with float
        ``render`` calls is supported: frames carried over from an f32 render
        quantize on host with the same formula; leftover frames of a pcm16
        render are carried back dequantized (v / 32767), which re-quantizes
        bit-identically on the next pcm16 call.
        """
        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        if frame_count == 0:
            return np.zeros(0, dtype=np.int16)

        chunks = []  # (flat interleaved int16, channel count)
        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            part = self._carry[:, :take]
            self._carry = (
                self._carry[:, take:] if take < self._carry.shape[1] else None
            )
            pcm = np.round(np.clip(part, -1.0, 1.0) * np.float32(32767.0))
            chunks.append((
                np.ascontiguousarray(pcm.T.astype(np.int16)).reshape(-1),
                part.shape[0],
            ))
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            out = self._render_steps(n_steps, pack="int16")
            ch = max(self._dest_channels or 0, 1)
            total = out.shape[0] // ch
            if total > remaining:
                flat = out.reshape(total, ch)
                self._carry = np.ascontiguousarray(
                    flat[remaining:].T.astype(np.float32) / np.float32(32767.0)
                )
                out = np.ascontiguousarray(flat[:remaining]).reshape(-1)
                total = remaining
            chunks.append((out, ch))
            remaining -= total

        if len(chunks) == 1:
            return chunks[0][0]
        # A timed-command topology edit can change the destination channel
        # count mid-call; mixed interleave strides cannot share one flat
        # stream, so pad every segment to the widest count (silent extra
        # channels — same rule as the float path).
        width = max(c for _, c in chunks)
        if all(c == width for _, c in chunks):
            return np.concatenate([f for f, _ in chunks])
        padded = []
        for flat, c in chunks:
            if c == width:
                padded.append(flat)
                continue
            frames = flat.reshape(-1, c)
            wide = np.zeros((frames.shape[0], width), dtype=np.int16)
            wide[:, :c] = frames
            padded.append(wide.reshape(-1))
        return np.concatenate(padded)

    # -- compressed wire formats ---------------------------------------------
    #
    # The reference's device path is interleaved PCM (AudioContextBase.cs:
    # 88-161). Where pulling that PCM to the host bounds the offline wall
    # time, the context also offers standard compressed wire formats
    # encoded ON DEVICE: G.711 mu-law (1 byte/sample) and IMA
    # ADPCM (~4.06 bits/sample). Both are lossy delivery formats; the f32 and
    # pcm16 paths remain the accuracy-bearing surfaces.

    def render_mulaw(self, frame_count: int) -> np.ndarray:
        """Render ``frame_count`` frames as interleaved G.711 mu-law bytes.

        Standard mu-law companding of the int16-quantized signal runs ON
        DEVICE (ops.wire.pack_mulaw) — 1 byte/sample, ~38 dB SNDR, decodable
        by any G.711 decoder (gacodec reads it as WAV fmt tag 7; see
        ops.wire.mulaw_wav_bytes) or ops.wire.mulaw_decode_np.

        Frames carried in from a previous float render encode on host with
        the same formula. Frames over-rendered past ``frame_count``
        (superblock granularity) render UNPACKED and carry as exact float32,
        so subsequent render calls continue bit-identically to an all-f32
        session (mu-law is lossy; its expansion never feeds back into the
        carry).
        """
        from graphaudio_tpu.ops import wire

        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        if frame_count == 0:
            return np.zeros(0, dtype=np.uint8)

        chunks = []  # (flat mu-law bytes, channel count)
        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            part = self._carry[:, :take]
            self._carry = (
                self._carry[:, take:] if take < self._carry.shape[1] else None
            )
            chunks.append((wire.mulaw_encode_np(part), part.shape[0]))
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            seg = n_steps * frames_per_step
            if seg > remaining:
                # Final segment overshoots: render the last superblock
                # unpacked so the excess frames carry as exact float32
                # (mu-law expansion would leak ~2% error into later renders).
                if n_steps > 1:
                    out = self._render_steps(n_steps - 1, pack="mulaw")
                    ch = max(self._dest_channels or 0, 1)
                    chunks.append((out, ch))
                    remaining -= (n_steps - 1) * frames_per_step
                out = self._render_steps(1)  # f32 [C, frames_per_step]
                take = min(remaining, out.shape[1])
                chunks.append(
                    (wire.mulaw_encode_np(out[:, :take]), out.shape[0])
                )
                if out.shape[1] > take:
                    self._carry = np.ascontiguousarray(out[:, take:])
                remaining = 0
            else:
                out = self._render_steps(n_steps, pack="mulaw")
                ch = max(self._dest_channels or 0, 1)
                chunks.append((out, ch))
                remaining -= seg

        if len(chunks) == 1:
            return chunks[0][0]
        width = max(c for _, c in chunks)
        if all(c == width for _, c in chunks):
            return np.concatenate([f for f, _ in chunks])
        # Mid-call channel-count change (timed topology edit): pad every
        # segment to the widest count. Silence in mu-law is 0xFF (the
        # encoding of 0), not 0x00.
        padded = []
        for flat, c in chunks:
            if c == width:
                padded.append(flat)
                continue
            frames = flat.reshape(-1, c)
            wide = np.full((frames.shape[0], width), 0xFF, dtype=np.uint8)
            wide[:, :c] = frames
            padded.append(wide.reshape(-1))
        return np.concatenate(padded)

    def render_adpcm(self, frame_count: int, samples_per_block: int = None):
        """Render ``frame_count`` frames as a standard IMA ADPCM stream.

        Returns :class:`graphaudio_tpu.ops.wire.AdpcmStream` — WAV tag-0x11
        blocks, ~4.06 bits/sample at the default 505-sample block (~3.9x
        fewer wire bytes than int16 PCM). Blocks encode ON DEVICE: vmap over
        (blocks x channels), one lax.scan over the in-block samples, with
        block-boundary carry threaded across launch chunks so the whole call
        yields ONE contiguous stream (``stream.write_wav(path)`` produces a
        file gacodec — or any WAV-IMA reader — decodes; round-trip is
        bit-exact vs ops.wire.ima_decode_np).

        ADPCM is a lossy delivery format (~30 dB SNR on broadband
        material) — use it for wire/file delivery, not intermediate mixing.
        Frames over-rendered past ``frame_count`` (superblock granularity)
        render UNPACKED and carry as exact float32, so subsequent render
        calls continue bit-identically to an all-f32 session. An ADPCM
        stream has a fixed channel layout: a timed command that changes the
        destination channel count mid-call raises; render across such edits
        with separate calls.
        """
        from graphaudio_tpu.ops import wire

        if frame_count < 0:
            raise ValueError("frame_count must be non-negative")
        spb = wire._validate_spb(
            samples_per_block
            if samples_per_block is not None
            else wire.DEFAULT_SAMPLES_PER_BLOCK
        )
        # The stream's channel layout is fixed up front: drain + compile now.
        self._drain_commands()
        self._ensure_compiled()
        ch = max(self._dest_channels or 0, 1)
        stream = wire.ImaDeviceStream(ch, spb)
        block_parts: List[np.ndarray] = []

        def host_blocks(q: np.ndarray, pad_final: bool) -> np.ndarray:
            """Host-encode int16 [ch, n]: whole blocks (+ padded final when
            flushing); the sub-block remainder seeds the device carry."""
            whole = (q.shape[1] // spb) * spb
            if whole:
                block_parts.append(wire.ima_encode_np(q[:, :whole], spb))
            rem = q[:, whole:]
            if pad_final:
                if rem.shape[1]:
                    padded = np.concatenate(
                        [rem, np.zeros((ch, spb - rem.shape[1]), np.int16)],
                        axis=1,
                    )
                    block_parts.append(wire.ima_encode_np(padded, spb))
            else:
                stream.set_carry(rem)

        got = 0
        if self._carry is not None and self._carry.shape[1] > 0:
            take = min(frame_count, self._carry.shape[1])
            part = self._carry[:, :take]
            self._carry = (
                self._carry[:, take:] if take < self._carry.shape[1] else None
            )
            if part.shape[0] != ch:  # topology edited since the carry
                fixed = np.zeros((ch, part.shape[1]), np.float32)
                fixed[: min(ch, part.shape[0])] = part[: min(ch, part.shape[0])]
                part = fixed
            host_blocks(wire.quantize_i16(part), pad_final=False)
            got += take

        remaining = frame_count - got
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        while remaining > 0:
            n_steps = self._segment_cap(-(-remaining // frames_per_step))
            seg = n_steps * frames_per_step
            if seg > remaining:
                # Final segment overshoots frame_count: render all but the
                # last superblock packed, the last one unpacked f32 so the
                # excess frames carry losslessly.
                if n_steps > 1:
                    blocks = self._render_steps(n_steps - 1, pack=stream)
                    if blocks.size:
                        block_parts.append(blocks)
                    remaining -= (n_steps - 1) * frames_per_step
                out = self._render_steps(1)  # f32 [C, frames_per_step]
                take = min(remaining, out.shape[1])
                part = out[:, :take]
                if part.shape[0] != ch:  # topology edited mid-call
                    fixed = np.zeros((ch, take), np.float32)
                    fixed[: min(ch, part.shape[0])] = part[: min(ch, part.shape[0])]
                    part = fixed
                lead = stream.pull_carry()
                tail = np.concatenate([lead, wire.quantize_i16(part)], axis=1)
                host_blocks(tail, pad_final=True)
                if out.shape[1] > take:
                    self._carry = np.ascontiguousarray(out[:, take:])
                remaining = 0
            else:
                blocks = self._render_steps(n_steps, pack=stream)
                if blocks.size:
                    block_parts.append(blocks)
                remaining -= seg
        if stream.carry_len:
            host_blocks(stream.pull_carry(), pad_final=True)

        blocks_all = (
            np.concatenate(block_parts, axis=0)
            if block_parts
            else np.zeros((0, stream.block_align), np.uint8)
        )
        return wire.AdpcmStream(
            blocks=blocks_all,
            channels=ch,
            samples_per_block=spb,
            sample_rate=self.sample_rate,
            frames=frame_count,
        )


def _same_structure(a, b) -> bool:
    ta = jax.tree_util.tree_structure(a)
    tb = jax.tree_util.tree_structure(b)
    if ta != tb:
        return False
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    return all(
        np.shape(x) == np.shape(y) and np.asarray(x).dtype == np.asarray(y).dtype
        for x, y in zip(la, lb)
    )


class OfflineAudioContext(AudioContextBase):
    """Non-realtime renderer (parity: GraphAudio.Core/OfflineAudioContext.cs:8).

    ``render(frame_count)`` pulls exactly ``frame_count`` frames through the
    graph (implementation on the base context, shared with realtime's
    block-level pulls)."""

    def __init__(
        self,
        sample_rate: int = DEFAULT_SAMPLE_RATE,
        superblock: int = DEFAULT_SUPERBLOCK,
        pipeline_chains: bool = True,
    ):
        super().__init__(sample_rate=sample_rate, superblock=superblock,
                         pipeline_chains=pipeline_chains)

    def render_seconds(self, seconds: float) -> np.ndarray:
        return self.render(int(round(seconds * self.sample_rate)))
