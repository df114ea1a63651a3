"""nvfpcc_tpu — a JAX neural volumetric field codec for point-cloud geometry.

A from-scratch JAX/XLA framework with the capabilities of the NVFPCC
reference (Hu & Wang, "Learning Neural Volumetric Field for Point Cloud
Geometry Compression", PCS 2022): octree leaf-block partitioning, per-block
latent embeddings + a shared quantization-aware deconvolutional decoder
overfit to a single cloud under a rate-distortion loss, and a fully
reciprocal encode/decode bitstream (Huffman-coded quantized weights +
range-coded latents + raw block origins).

Layer map (mirrors reference layers, rebuilt as compiled JAX programs):

- ``nvfpcc_tpu.io``      — PLY reader/writer (host, numpy).
- ``nvfpcc_tpu.octree``  — octree leaf partitioner (numpy + native C++ tool),
  capability of ``get_octree.cpp``.
- ``nvfpcc_tpu.grids``   — occupancy + exact distance grids via on-device
  integer EDT, capability of ``util_get_grids.py`` (KD-tree replaced by a
  separable min-plus distance transform).
- ``nvfpcc_tpu.ops``     — STE rounding/bounds, GDN/IGDN, seeded quantized
  convs, Gaussian/Laplace rate models.
- ``nvfpcc_tpu.models``  — latent generator, entropy bottleneck, CompDecoder.
- ``nvfpcc_tpu.train``   — jitted two-optimizer training loop (net per batch,
  embeddings once per epoch over the full set).
- ``nvfpcc_tpu.parallel``— block-data-parallel sharding over a device mesh.
- ``nvfpcc_tpu.coder``   — host C++ range coder (integer CDF tables) and
  canonical Huffman coder for weight residuals.
- ``nvfpcc_tpu.codec``   — encode/decode orchestration + pack container.
- ``nvfpcc_tpu.cli``     — ``train | encode | decode | grids`` commands,
  flag-compatible with the reference README workflow.
"""

__version__ = "0.1.0"
