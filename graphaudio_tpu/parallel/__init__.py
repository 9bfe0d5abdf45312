"""Multi-chip scaling via jax.sharding / shard_map over device meshes.

The reference is a single-process engine whose only concurrency is
thread-level (SURVEY.md §2.7). Its multi-device scaling story (this module):

* **Voice parallelism** (data-parallel analogue): independent voices shard
  across a mesh axis; the fan-in mix at a bus input becomes one ``psum`` over
  the device interconnect (NVLink between GPUs) — the collective form of AudioNodeInput's summing junction
  (AudioNodeInput.cs:100-138).
* **IR-partition parallelism** (tensor-parallel analogue): a partitioned
  convolver's spectral MAC shards the partition axis across devices, each
  correlating its slice of the frequency-domain delay line, combined with a
  ``psum`` — the "long context" scaling axis (SURVEY.md §5).
"""

from graphaudio_tpu.parallel.sharded import ShardedVoiceScene, make_mesh

__all__ = ["ShardedVoiceScene", "make_mesh"]
