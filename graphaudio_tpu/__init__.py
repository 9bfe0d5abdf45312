"""graphaudio_tpu — an audio-graph rendering framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of GraphAudio
(the-byte-bender/GraphAudio, a Web-Audio-API-style C# engine; see SURVEY.md):
node graphs of sources, filters, and spatializers rendered in 128-frame quanta
with sample-accurate parameter automation.

Architecture (compiled dataflow, not a translation):
  * Graphs are built on the host with an object API mirroring the reference's
    node/param surface (``GraphAudio.Core/Nodes/AudioNode.cs``), then compiled
    to a single jitted function over a pytree of node states.
  * Offline rendering scans that function over "superblocks" of S render
    quanta (``lax.scan``), so per-block Python/dispatch overhead vanishes and
    XLA fuses the whole graph into a handful of device kernels.
  * Hot DSP (partitioned-FFT convolution, biquad IIR, resampling, parameter
    curve evaluation) is expressed as batched ``jnp``/``lax`` tensor ops.
  * Clocks, phases, and playback positions use float64 (tiny tensors) to
    match the reference's double-precision accumulators; audio is float32.

Import side effects: enables ``jax_enable_x64`` (required for sample-accurate
clock arithmetic; all library arrays are explicitly dtyped, so f32 audio
paths are unaffected), and places JAX's persistent compilation cache (below).
"""

import os as _os
import warnings as _warnings

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: identical programs recur across
# processes (services restart, CLIs rerun). JAX_COMPILATION_CACHE_DIR, or a
# directory the embedding application already configured, wins; otherwise
# the cache lives at one fixed path inside the checkout. The path is part of
# the cache's key, so it must not vary between runs.
_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)
if not (
    _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    or _jax.config.jax_compilation_cache_dir
):
    try:
        _os.makedirs(_CACHE_DIR, exist_ok=True)
    except OSError as _e:
        _warnings.warn(
            f"graphaudio_tpu: compilation cache disabled, cannot create "
            f"{_CACHE_DIR}: {_e}",
            RuntimeWarning,
        )
    else:
        _jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK, DEFAULT_SAMPLE_RATE, MAX_CHANNELS
from graphaudio_tpu.core.buffer import PlayableAudioBuffer
from graphaudio_tpu.core.params import AudioParam, AutomationRate
from graphaudio_tpu.core.node import (
    AudioNode,
    AudioNodeInput,
    AudioNodeOutput,
    ChannelCountMode,
    ChannelInterpretation,
)
from graphaudio_tpu.core.context import AudioContextBase, OfflineAudioContext
from graphaudio_tpu.nodes import (
    AudioDestinationNode,
    GainNode,
    ConstantSourceNode,
    OscillatorNode,
    OscillatorType,
    AudioBufferSourceNode,
    BiQuadFilterNode,
    FilterType,
    DelayNode,
    StereoPannerNode,
    ChannelSplitterNode,
    ChannelMergerNode,
    ConvolverNode,
)
from graphaudio_tpu.nodes.spatial import SpatialPannerNode, DistanceModelType

__version__ = "0.1.0"

__all__ = [
    "FRAMES_PER_BLOCK",
    "DEFAULT_SAMPLE_RATE",
    "MAX_CHANNELS",
    "PlayableAudioBuffer",
    "AudioParam",
    "AutomationRate",
    "AudioNode",
    "AudioNodeInput",
    "AudioNodeOutput",
    "ChannelCountMode",
    "ChannelInterpretation",
    "AudioContextBase",
    "OfflineAudioContext",
    "AudioDestinationNode",
    "GainNode",
    "ConstantSourceNode",
    "OscillatorNode",
    "OscillatorType",
    "AudioBufferSourceNode",
    "BiQuadFilterNode",
    "FilterType",
    "DelayNode",
    "StereoPannerNode",
    "ChannelSplitterNode",
    "ChannelMergerNode",
    "ConvolverNode",
    "SpatialPannerNode",
    "DistanceModelType",
]
