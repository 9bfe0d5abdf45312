"""Host-side audio graph model: nodes, ports, connections.

Mirrors the public API of GraphAudio.Core/Nodes/AudioNode.cs (ports,
``connect``/``disconnect`` with chaining, param registry, dispose) and
GraphAudio.Core/AudioNodeInput.cs / AudioNodeOutput.cs (fan-in/fan-out ports,
channel count modes).

Compiled-graph difference: nodes do not process themselves via pull-based virtual
dispatch. They are *descriptions*. The context's graph compiler topo-sorts the
connection graph, resolves static channel counts, and emits one jitted render
function; each node contributes a pure functional kernel via

    init_state(ctx)                     -> state pytree (numpy arrays)
    process(state, inputs, params, rc)  -> (state, [outputs])

where ``inputs`` are mixed [channels, T] blocks, ``params`` maps param name to
a ParamSignal, and ``rc`` is the per-step RenderContext.
"""

from __future__ import annotations

import enum
import itertools
from typing import Dict, List, Optional, Sequence

from graphaudio_tpu.core.constants import MAX_CHANNELS
from graphaudio_tpu.core.params import AudioParam, AutomationRate

_node_ids = itertools.count(1)


class ChannelInterpretation(enum.Enum):
    """Parity: AudioNodeInput.cs:247-257."""

    SPEAKERS = "speakers"
    DISCRETE = "discrete"


class ChannelCountMode(enum.Enum):
    """Parity: AudioNodeInput.cs:259-273."""

    MAX = "max"
    CLAMPED_MAX = "clamped-max"
    EXPLICIT = "explicit"


class AudioNodeInput:
    """Fan-in summing junction on a node (AudioNodeInput.cs:11)."""

    def __init__(self, owner: "AudioNode", index: int):
        self.owner = owner
        self.index = index
        self.connected_outputs: List["AudioNodeOutput"] = []
        self._channel_count = 2
        self._mode = ChannelCountMode.MAX
        self._interpretation = ChannelInterpretation.SPEAKERS

    @property
    def channel_count(self) -> int:
        return self._channel_count

    @property
    def channel_count_mode(self) -> ChannelCountMode:
        return self._mode

    @property
    def channel_interpretation(self) -> ChannelInterpretation:
        return self._interpretation

    def set_channel_count(self, count: int) -> None:
        """Parity: AudioNodeInput.SetChannelCount (:41-48)."""
        if not (1 <= count <= MAX_CHANNELS):
            raise ValueError(
                f"Channel count must be between 1 and {MAX_CHANNELS}"
            )
        self._channel_count = count
        self.owner._graph_changed()

    def set_channel_count_mode(self, mode: ChannelCountMode) -> None:
        self._mode = mode
        self.owner._graph_changed()

    def set_channel_interpretation(self, interp: ChannelInterpretation) -> None:
        self._interpretation = interp
        self.owner._graph_changed()

    def _add_connection(self, output: "AudioNodeOutput") -> None:
        if output not in self.connected_outputs:
            self.connected_outputs.append(output)
            self.owner._graph_changed()

    def _remove_connection(self, output: "AudioNodeOutput") -> None:
        if output in self.connected_outputs:
            self.connected_outputs.remove(output)
            self.owner._graph_changed()

    def disconnect_all(self) -> None:
        for output in list(self.connected_outputs):
            output.disconnect_from(self)


class AudioNodeOutput:
    """Fan-out port (AudioNodeOutput.cs:10)."""

    def __init__(self, owner: "AudioNode", index: int):
        self.owner = owner
        self.index = index
        self.connections: List[AudioNodeInput] = []
        self.param_connections: List[AudioParam] = []

    def connect_to(self, input_port: AudioNodeInput) -> None:
        if input_port.owner is self.owner:
            # Self-connection guard (AudioNodeOutput.cs:44-45).
            raise ValueError("Cannot connect a node to itself")
        if input_port not in self.connections:
            self.connections.append(input_port)
            input_port._add_connection(self)

    def disconnect_from(self, input_port: AudioNodeInput) -> None:
        if input_port in self.connections:
            self.connections.remove(input_port)
            input_port._remove_connection(self)

    def connect_to_param(self, param: AudioParam) -> None:
        if param not in self.param_connections:
            self.param_connections.append(param)
            param._mod_outputs.append(self)
            param._owner._graph_changed()

    def disconnect_from_param(self, param: AudioParam) -> None:
        if param in self.param_connections:
            self.param_connections.remove(param)
            param._mod_outputs.remove(self)
            param._owner._graph_changed()

    def disconnect_all(self) -> None:
        for inp in list(self.connections):
            self.disconnect_from(inp)
        for p in list(self.param_connections):
            self.disconnect_from_param(p)


class AudioNode:
    """Base class for all graph nodes (parity: AudioNode.cs:10).

    Subclasses declare ports in ``__init__`` and implement the functional
    kernel interface (``init_state`` / ``process`` / ``output_channel_counts``).
    """

    def __init__(self, context, input_count: int, output_count: int, name: Optional[str] = None):
        self.node_id = next(_node_ids)
        self.context = context
        self.name = name or type(self).__name__
        self.inputs = [AudioNodeInput(self, i) for i in range(input_count)]
        self.outputs = [AudioNodeOutput(self, i) for i in range(output_count)]
        self.params: Dict[str, AudioParam] = {}
        self._disposed = False
        context._register_node(self)

    # -- graph construction --------------------------------------------------

    def create_audio_param(
        self,
        name: str,
        default_value: float,
        min_value: float = -3.4028235e38,
        max_value: float = 3.4028235e38,
        automation_rate: AutomationRate = AutomationRate.A_RATE,
    ) -> AudioParam:
        """Parity: AudioNode.CreateAudioParam (AudioNode.cs:52-62)."""
        param = AudioParam(self, name, default_value, min_value, max_value, automation_rate)
        self.params[name] = param
        return param

    def connect(self, destination, output: int = 0, input: int = 0):
        """Connect to a node (returns it, for chaining) or to an AudioParam.

        Parity: AudioNode.Connect (AudioNode.cs:68-92).
        """
        if not (0 <= output < len(self.outputs)):
            raise IndexError("output index out of range")
        if isinstance(destination, AudioParam):
            self.outputs[output].connect_to_param(destination)
            return destination
        if not (0 <= input < len(destination.inputs)):
            raise IndexError("input index out of range")
        self.outputs[output].connect_to(destination.inputs[input])
        return destination

    def disconnect(self, destination=None, output: int = 0, input: int = 0) -> None:
        """Parity: AudioNode.Disconnect (AudioNode.cs:78-103, 129-150)."""
        if not (0 <= output < len(self.outputs)):
            raise IndexError("output index out of range")
        if isinstance(destination, AudioParam):
            self.outputs[output].disconnect_from_param(destination)
            return
        if destination is None:
            self.outputs[output].disconnect_all()
        else:
            if not (0 <= input < len(destination.inputs)):
                raise IndexError("input index out of range")
            self.outputs[output].disconnect_from(destination.inputs[input])

    def dispose(self) -> None:
        """Disconnect everywhere and mark dead (AudioNode.cs:207-238)."""
        if self._disposed:
            return
        self._disposed = True
        for output in self.outputs:
            output.disconnect_all()
        for inp in self.inputs:
            inp.disconnect_all()
        for param in self.params.values():
            for out in list(param._mod_outputs):
                out.disconnect_from_param(param)
        self.context._unregister_node(self)

    @property
    def disposed(self) -> bool:
        return self._disposed

    def _graph_changed(self) -> None:
        self.context._invalidate_topology()

    def _config_changed(self) -> None:
        """A compile-time attribute changed (filter type, IR, ...): bump the
        node's static fingerprint so cached compiled programs can't be reused
        with stale baked-in configuration."""
        self._config_version = getattr(self, "_config_version", 0) + 1
        self._graph_changed()

    def static_fingerprint(self):
        """Identity + config version; part of the compiled-program cache key
        for stages whose kernels close over instance data. Uses the monotonic
        ``node_id`` (never recycled), NOT ``id(self)`` — CPython reuses object
        ids after GC, which could alias a dead node's cached program onto a
        new node with different baked-in config."""
        return (self.node_id, getattr(self, "_config_version", 0))

    # -- functional kernel interface ------------------------------------------

    def init_state(self, rc) -> dict:
        """Return the node's initial state pytree (numpy/jnp arrays)."""
        return {}

    def process(self, state, inputs, params, rc):
        """Pure per-superblock kernel.

        Args:
          state: this node's state pytree.
          inputs: list of mixed f32[channels, T] blocks, one per input port.
          params: dict name -> ParamSignal.
          rc: RenderContext (times, sample rate, superblock geometry).

        Returns (new_state, [f32[channels, T] per output port]).
        """
        raise NotImplementedError

    def output_channel_counts(self, input_channels: Sequence[int]) -> List[int]:
        """Static output channel counts given resolved input channel counts."""
        # Default: single output mirroring the first input (filter-like nodes).
        if not self.outputs:
            return []
        c = input_channels[0] if input_channels else 2
        return [c] * len(self.outputs)

    def group_key(self, input_channels):
        """Hashable batching key, or None when this node can't join a vmapped
        voice stage.

        Nodes sharing a key are executed as ONE vmapped kernel over stacked
        states/params — the batched form of the reference's implicit voice-level
        parallelism (N sources summed at an input, AudioNodeInput.cs:100-138).
        Keys must capture every compile-time attribute the kernel reads
        (filter type, channel counts, specialization flags). Nodes with
        modulated params include ``_mod_signature()`` in their key: lanes
        agreeing on WHICH params carry modulation inputs batch together,
        with each lane's modulators routed like per-lane audio inputs
        (per-voice LFO -> gain stays ONE vmapped stage; see
        CompiledGraph.run_group). Buffer sources are the exception — a
        modulated playbackRate interacts with their static kernel variants,
        so they stay unbatched.
        """
        return None

    def _params_modulated(self) -> bool:
        return any(p._mod_outputs for p in self.params.values())

    def _mod_signature(self) -> tuple:
        """Sorted names of params with modulation inputs (joins group_key)."""
        return tuple(
            sorted(n for n, p in self.params.items() if p._mod_outputs)
        )

    def notify_rendered(self, state, end_time: float) -> None:
        """Host callback after a render step with this node's updated state.

        Scheduled sources override this to raise ``ended`` events and
        self-dispose (parity: OscillatorNode.TryRaiseEndedAndDisconnect,
        AudioBufferSourceNode.TryRaiseEndedEvent).
        """

    def __repr__(self) -> str:
        return f"{type(self).__name__}(id={self.node_id}, name={self.name!r})"
