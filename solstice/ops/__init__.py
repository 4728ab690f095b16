"""Compute kernels: vector math, intersections, BVH, shading, render loop.

Re-creation of the reference's device-kernel layer
(solr/engines/cuda/*.cuh + CudaRayTracer.cu and the OpenCL mirror
solr/engines/opencl/RayTracer.cl) as vectorized jax.numpy programs and
Pallas kernels.
"""
