"""Sample storage.

``PlayableAudioBuffer`` mirrors the reference's immutable multi-channel sample
container (GraphAudio.Core/PlayableAudioBuffer.cs:9): planar float32 channel
data at a fixed sample rate, initialized once and then read-only. On device the
channel data lives as one ``[channels, length]`` device array so batched voice
gathers read from a single arena.
"""

from __future__ import annotations

import itertools

import numpy as np

from graphaudio_tpu.core.constants import MAX_CHANNELS


class PlayableAudioBuffer:
    """Immutable multi-channel audio sample storage.

    Parity: GraphAudio.Core/PlayableAudioBuffer.cs:45 (ctor),
    :122-174 (factories). The reference's memory-barrier publication protocol
    becomes plain immutability here: ``data`` is a frozen numpy array, uploaded
    to the device lazily by consumers.
    """

    __slots__ = ("_data", "_sample_rate", "_initialized", "_uid")

    _uids = itertools.count(1)

    def __init__(self, number_of_channels: int, length: int, sample_rate: int):
        self._uid = next(PlayableAudioBuffer._uids)
        if not (1 <= number_of_channels <= MAX_CHANNELS):
            raise ValueError(
                f"number_of_channels must be in [1, {MAX_CHANNELS}], got {number_of_channels}"
            )
        if length <= 0:
            raise ValueError(f"length must be positive, got {length}")
        if sample_rate <= 0:
            raise ValueError(f"sample_rate must be positive, got {sample_rate}")
        self._data = np.zeros((number_of_channels, length), dtype=np.float32)
        self._sample_rate = int(sample_rate)
        self._initialized = False

    # -- population (write-once) ------------------------------------------

    def set_channel_data(self, channel: int, samples) -> None:
        """Copy samples into a channel. Only valid before initialization."""
        if self._initialized:
            raise RuntimeError("PlayableAudioBuffer is immutable after initialize()")
        arr = np.asarray(samples, dtype=np.float32)
        if arr.ndim != 1 or arr.shape[0] != self.length:
            raise ValueError(f"expected 1-D array of length {self.length}")
        self._data[channel] = arr

    def initialize(self) -> "PlayableAudioBuffer":
        """Freeze the buffer. Mirrors PlayableAudioBuffer.Initialize (:72)."""
        self._data.setflags(write=False)
        self._initialized = True
        return self

    # -- properties --------------------------------------------------------

    @property
    def uid(self) -> int:
        """Monotonic identity token (never recycled, unlike ``id(self)``);
        used as a cache key by consumers that bake sample data into compiled
        regions."""
        return self._uid

    @property
    def is_initialized(self) -> bool:
        return self._initialized

    @property
    def number_of_channels(self) -> int:
        return self._data.shape[0]

    @property
    def length(self) -> int:
        return self._data.shape[1]

    @property
    def sample_rate(self) -> int:
        return self._sample_rate

    @property
    def duration(self) -> float:
        return self.length / self._sample_rate

    @property
    def data(self) -> np.ndarray:
        """Planar [channels, length] float32 sample data (read-only view)."""
        return self._data

    def get_channel_data(self, channel: int) -> np.ndarray:
        return self._data[channel]

    # -- factories (parity: PlayableAudioBuffer.cs:122-174) ----------------

    @staticmethod
    def from_channel_arrays(channels, sample_rate: int) -> "PlayableAudioBuffer":
        arrs = [np.asarray(c, dtype=np.float32) for c in channels]
        if not arrs:
            raise ValueError("at least one channel required")
        length = arrs[0].shape[0]
        for a in arrs:
            if a.shape != (length,):
                raise ValueError("all channels must have the same length")
        buf = PlayableAudioBuffer(len(arrs), length, sample_rate)
        for i, a in enumerate(arrs):
            buf.set_channel_data(i, a)
        return buf.initialize()

    @staticmethod
    def from_mono_array(samples, sample_rate: int) -> "PlayableAudioBuffer":
        return PlayableAudioBuffer.from_channel_arrays([samples], sample_rate)

    @staticmethod
    def from_stereo_arrays(left, right, sample_rate: int) -> "PlayableAudioBuffer":
        return PlayableAudioBuffer.from_channel_arrays([left, right], sample_rate)

    @staticmethod
    def from_interleaved(samples, channels: int, sample_rate: int) -> "PlayableAudioBuffer":
        """Deinterleave [n*channels] samples into planar storage."""
        arr = np.asarray(samples, dtype=np.float32).reshape(-1, channels)
        return PlayableAudioBuffer.from_channel_arrays(
            [arr[:, c] for c in range(channels)], sample_rate
        )

    def __repr__(self) -> str:
        return (
            f"PlayableAudioBuffer(channels={self.number_of_channels}, "
            f"length={self.length}, rate={self._sample_rate}, "
            f"initialized={self._initialized})"
        )
