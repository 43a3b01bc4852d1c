"""Batches and long signals over several devices (``sspv_tpu.parallel``)."""

from .mesh import BatchPipeline, Mesh, make_mesh

__all__ = ["BatchPipeline", "Mesh", "make_mesh"]
