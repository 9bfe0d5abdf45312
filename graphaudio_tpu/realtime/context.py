"""Realtime audio context: render thread -> native ring -> device callback.

Parity: GraphAudio.Realtime/RealtimeAudioContext.cs — ring capacity =
buffer_size * 5 (:38), a dedicated render thread that fills the ring whenever
>= 128 frames of space exist and otherwise waits on the space semaphore
(:143-165), a device callback that drains the ring natively with underrun
zero-fill (:167-235), and device enumeration/selection (:55-141).

Device execution: the render thread runs the same compiled superblock step as
the offline context (small superblock for low latency) and writes interleaved
quanta into the native ring; the C++ device thread (see native/garing.cpp)
consumes it in real time without touching Python.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from graphaudio_tpu.core.constants import FRAMES_PER_BLOCK
from graphaudio_tpu.core.context import AudioContextBase
from graphaudio_tpu.realtime.ring import RingBuffer, load_native


@dataclass(frozen=True)
class AudioDeviceInfo:
    """Parity: AudioDeviceInfo (RealtimeAudioContext.cs:272-313)."""

    name: str
    is_default: bool
    backend: str = "null"


class RealtimeAudioContext(AudioContextBase):
    def __init__(
        self,
        sample_rate: int = 48000,
        channels: int = 2,
        buffer_size: int = 256,
        device: Optional[str] = None,
        superblock: int = 2,
        auto_tune: bool = False,
        auto_start_thread: bool = True,
    ):
        """``auto_tune=True`` measures the per-step host-device round
        trip at startup and grows ``superblock`` (and the ring, via
        ``buffer_size``) until one step's audio duration clears it with
        margin: when a call costs more than the default ``superblock=2``'s
        5.3 ms of audio, every step underruns, and without validation the
        only signal is post-hoc underrun counters. Warns if even the
        largest superblock cannot clear the measured round trip. When the
        round trip is short the requested geometry is kept. The chosen
        values are inspectable as ``superblock`` / ``tuned_rtt_s``."""
        self.tuned_rtt_s: Optional[float] = None
        if auto_tune:
            rtt = self._measure_step_rtt()
            superblock, buffer_size = self._tune_geometry(
                rtt, sample_rate, superblock, buffer_size
            )
            self.tuned_rtt_s = rtt
        super().__init__(sample_rate=sample_rate, superblock=superblock)
        self.channels = channels
        self.buffer_size = buffer_size
        #: last exception survived by the render thread (None = healthy)
        self.last_render_error = None
        self.destination.set_channel_count(channels)
        # Ring capacity = bufferSize * 5 (parity :38).
        self.ring = RingBuffer(channels, buffer_size * 5)

        # "auto" = real hardware (ALSA via dlopen'd libasound) when present,
        # else the clock-paced null backend — the reference's miniaudio
        # default-device behavior (Miniaudio.cs:303-349). Explicit "alsa"
        # requests fail loudly instead of silently degrading.
        self._device_name = device or "auto"
        self._lib = load_native()
        self._dev = None
        if self._lib is not None and self.ring.native_handle is not None:
            self._dev = self._lib.gadev_open(
                self._device_name.encode(),
                self.ring.native_handle,
                sample_rate,
                channels,
                buffer_size,
            )
            if self._dev is None:
                raise RuntimeError(
                    f"could not open audio device {self._device_name!r}"
                )

        self._running = False
        self._thread_quit = False
        self._render_thread: Optional[threading.Thread] = None
        self._render_thread_id: Optional[int] = None
        if auto_start_thread:
            self._start_render_thread()

    # -- startup round-trip validation / geometry auto-tuning ------------------

    @staticmethod
    def _measure_step_rtt(samples: int = 5) -> float:
        """Per-step wall-time floor: the round trip of a minimal jitted
        device call, launch through device_get (every render step pays at
        least this regardless of graph size)."""
        import time

        import jax
        import jax.numpy as jnp

        f = jax.jit(lambda x: x + jnp.float32(1.0))
        x = jnp.zeros((FRAMES_PER_BLOCK,), jnp.float32)
        np.asarray(jax.device_get(f(x)))  # compile + warm
        walls = []
        for _ in range(max(samples, 2)):
            t0 = time.perf_counter()
            np.asarray(jax.device_get(f(x)))
            walls.append(time.perf_counter() - t0)
        walls.sort()
        return walls[int(0.8 * (len(walls) - 1))]

    @staticmethod
    def _tune_geometry(
        rtt_s: float,
        sample_rate: int,
        min_superblock: int,
        buffer_size: int,
        margin: float = 1.25,
        max_superblock: int = 64,
    ):
        """Smallest superblock whose per-step audio duration covers the
        measured round trip with ``margin`` (the 2-deep launch/finish
        pipeline hides ONE step's latency; throughput still needs
        audio-per-step >= step wall). The ring is grown to hold 2.5 steps
        (buffer_size = superblock*64 -> ring = superblock*320 frames): a
        ring that only fits one step must fully drain before each render —
        guaranteed periodic underruns when the round trip is long."""
        import warnings

        s = max(1, int(min_superblock))
        while (
            s < max_superblock
            and s * FRAMES_PER_BLOCK / sample_rate < margin * rtt_s
        ):
            s *= 2
        if s * FRAMES_PER_BLOCK / sample_rate < margin * rtt_s:
            warnings.warn(
                f"RealtimeAudioContext: measured per-step round trip "
                f"{rtt_s * 1e3:.1f} ms exceeds the largest superblock's "
                f"audio duration ({s * FRAMES_PER_BLOCK / sample_rate * 1e3:.1f} ms "
                f"at superblock {s}); realtime playback WILL underrun on "
                f"this device — use offline rendering",
                RuntimeWarning,
                stacklevel=3,
            )
        return s, max(int(buffer_size), s * FRAMES_PER_BLOCK // 2)

    # -- device enumeration (parity :55-141) -------------------------------------

    @staticmethod
    def get_available_devices() -> List[AudioDeviceInfo]:
        lib = load_native()
        if lib is None:
            return [AudioDeviceInfo("null", True)]
        buf = ctypes.create_string_buffer(4096)
        n = lib.gadev_enumerate(buf, 4096, 32)
        names = []
        off = 0
        for _ in range(n):
            s = ctypes.string_at(ctypes.addressof(buf) + off).decode()
            names.append(s)
            off += len(s) + 1
        return [
            AudioDeviceInfo(
                nm, i == 0, "alsa" if nm.startswith("alsa") else "null"
            )
            for i, nm in enumerate(names)
        ]

    @staticmethod
    def get_default_device() -> AudioDeviceInfo:
        return RealtimeAudioContext.get_available_devices()[0]

    def switch_device(self, name: str) -> None:
        """Hot-switch the output device (parity: SwitchDevice, :86-141)."""
        if self._lib is None or self.ring.native_handle is None:
            self._device_name = name
            return
        was_running = self._running
        if self._dev is not None:
            self._lib.gadev_close(self._dev)
        self._device_name = name
        self._dev = self._lib.gadev_open(
            name.encode(), self.ring.native_handle,
            self.sample_rate, self.channels, self.buffer_size,
        )
        if self._dev is None:
            raise RuntimeError(f"could not open audio device {name!r}")
        if was_running:
            self._lib.gadev_start(self._dev)

    # -- transport --------------------------------------------------------------------

    def start(self) -> None:
        """Parity: Start -> ma_device_start (:76-84)."""
        self._running = True
        if self._dev is not None:
            self._lib.gadev_start(self._dev)

    def stop(self) -> None:
        self._running = False
        if self._dev is not None:
            self._lib.gadev_stop(self._dev)

    @property
    def is_running(self) -> bool:
        return self._running

    @property
    def frames_played(self) -> int:
        return int(self._lib.gadev_frames_played(self._dev)) if self._dev else 0

    @property
    def underrun_frames(self) -> int:
        return int(self._lib.gadev_underruns(self._dev)) if self._dev else 0

    @property
    def device_backend(self) -> str:
        """Actual backend driving the output: "alsa" or "null"."""
        if self._dev is None:
            return "none"
        return self._lib.gadev_backend(self._dev).decode()

    # -- command routing: mutations funnel to the render thread --------------------

    def execute_or_post(self, command) -> None:
        """Graph mutations run on the render thread at step boundaries
        (parity: ExecuteOrPost, AudioContextBase.cs:291-305)."""
        if self._disposed:
            raise RuntimeError("context is disposed")
        if threading.get_ident() == self._render_thread_id:
            command(self)
        else:
            self._pending.append(command)

    # -- render thread (parity: RenderLoop, :143-165) ----------------------------------

    def _start_render_thread(self) -> None:
        self._render_thread = threading.Thread(
            target=self._render_loop, name="ga-render", daemon=True
        )
        self._render_thread.start()

    def _render_loop(self) -> None:
        self._render_thread_id = threading.get_ident()
        frames_per_step = self.superblock * FRAMES_PER_BLOCK
        # Two-deep pipeline: launch step n+1 BEFORE materializing step n's
        # audio, so the host-device round trip overlaps compute.
        pending = None

        def flush(p):
            try:
                out = self._render_steps_finish(p)  # [C, T]
            except Exception:
                if self._thread_quit or self._disposed:
                    return None
                raise
            self.ring.write_interleaved(np.ascontiguousarray(out.T))
            return None

        while not self._thread_quit:
            try:
                if not self._running:
                    if pending is not None:
                        pending = flush(pending)
                    threading.Event().wait(0.002)
                    continue
                if self.ring.available_write() >= frames_per_step:
                    nxt = self._render_steps_launch(1)
                    if pending is not None:
                        flush(pending)
                    pending = nxt
                else:
                    self.ring.wait_for_space(frames_per_step, 5)
            except Exception as exc:  # noqa: BLE001
                if self._thread_quit or self._disposed:
                    return
                # A transient failure (e.g. a decoder error surfacing
                # through feed staging) must not silently kill the render
                # thread while is_running stays True — the device would
                # drain the ring to zeros forever with no signal. Record
                # it, drop the in-flight step, and keep rendering; the app
                # can poll last_render_error / stats.render_errors.
                self.last_render_error = exc
                self.stats.render_errors += 1
                pending = None
                threading.Event().wait(0.002)

    def render_step_blocking(self) -> np.ndarray:
        """Render one superblock on the calling thread (for tests/tools)."""
        return self._render_steps(1)

    # -- lifecycle -----------------------------------------------------------------------

    def dispose(self) -> None:
        if self._disposed:
            return
        self._thread_quit = True
        self._running = False
        if self._render_thread is not None:
            self._render_thread.join(timeout=2.0)
        if self._dev is not None:
            self._lib.gadev_close(self._dev)
            self._dev = None
        self.ring.dispose()
        super().dispose()
