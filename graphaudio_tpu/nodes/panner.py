"""Equal-power stereo panner (parity: GraphAudio.Core/Nodes/StereoPannerNode.cs:9)."""

from __future__ import annotations

import math

import jax.numpy as jnp

from graphaudio_tpu.core.node import AudioNode, ChannelCountMode, ChannelInterpretation
from graphaudio_tpu.core.params import AutomationRate

_HALF_PI = math.pi / 2.0


class StereoPannerNode(AudioNode):
    """Positions the input in the stereo image with an equal-power law.

    Mono law (StereoPannerNode.cs:76-108):   x = (pan+1)/2,
        gL = cos(x*pi/2), gR = sin(x*pi/2);  L = in*gL, R = in*gR.
    Stereo law (:110-153): x = pan+1 for pan<=0 else pan;
        pan<=0: L = inL + inR*gL, R = inR*gR
        pan> 0: L = inL*gL,       R = inR + inL*gR.

    The reference's per-sample trig cache (:88-98) is a CPU optimization;
    here the trig is vectorized directly.
    """

    def __init__(self, context):
        super().__init__(context, input_count=1, output_count=1, name="StereoPanner")
        self.inputs[0].set_channel_count(2)
        self.inputs[0].set_channel_count_mode(ChannelCountMode.CLAMPED_MAX)
        self.inputs[0].set_channel_interpretation(ChannelInterpretation.SPEAKERS)
        self.pan = self.create_audio_param(
            "pan", 0.0, min_value=-1.0, max_value=1.0,
            automation_rate=AutomationRate.A_RATE,
        )

    def output_channel_counts(self, input_channels):
        return [2]

    def group_key(self, input_channels):
        return ("stereo-pan", input_channels[0], self._mod_signature())

    def process(self, state, inputs, params, rc):
        x_in = inputs[0]
        pan = jnp.clip(params["pan"].per_sample(), -1.0, 1.0)  # f32[T]

        if x_in.shape[0] == 1:
            x = (pan + 1.0) * 0.5
            gl = jnp.cos(x * _HALF_PI)
            gr = jnp.sin(x * _HALF_PI)
            mono = x_in[0]
            out = jnp.stack([mono * gl, mono * gr], axis=0)
        else:
            in_l, in_r = x_in[0], x_in[1]
            x = jnp.where(pan <= 0.0, pan + 1.0, pan)
            gl = jnp.cos(x * _HALF_PI)
            gr = jnp.sin(x * _HALF_PI)
            left_side = pan <= 0.0
            out_l = jnp.where(left_side, in_l + in_r * gl, in_l * gl)
            out_r = jnp.where(left_side, in_r * gr, in_r + in_l * gr)
            out = jnp.stack([out_l, out_r], axis=0)
        return state, [out]
