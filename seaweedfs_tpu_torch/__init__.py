"""seaweedfs_tpu_torch: the PyTorch/CUDA port of seaweedfs_tpu.

The erasure-coding data path (encode, rebuild, degraded read, repair,
ingest, conversion, scrub) runs down to hand-written CUDA kernels for the
GF(2^8) bit-plane product; around it sit the storage engine, the
transport, the master and volume servers, and the filer (which runs no
kernel). The EC and storage layers import torch, numpy and the standard
library only; the transport, the servers and the filer also import
grpc."""

__version__ = "0.1.0"
