"""Distributed execution over torch.distributed process groups.

Port of pykaldi2_tpu/parallel (reference behavior: Horovod allreduce and
broadcast_parameters). One process per card; the JAX package's mesh axes
become process groups (``mesh.py``), its psum'd train steps become
DistributedDataParallel with summing comm hooks (``data_parallel.py``,
used by trainer.py), and its output-layer tensor parallelism and BMUF are
libraries over the same groups (``tensor_parallel.py``, ``bmuf.py``).
"""

from pykaldi2_tpu_torch.parallel.mesh import (equalized_steps, init_distributed,
                                              local_batch_shard, make_mesh)
from pykaldi2_tpu_torch.parallel.data_parallel import psum_mean, replicate
