"""PyTorch/CUDA port of ``multimodal_organ_segmentation_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference. This package imports
neither it nor JAX. Entry points run on the CUDA device unless the caller
asks for the CPU; on a CUDA tensor every attention goes through the
hand-written kernels under ``csrc/``, on a CPU tensor through their plain
PyTorch versions.
"""
