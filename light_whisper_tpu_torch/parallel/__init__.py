"""Fine-tuning over a (dp, tp) device mesh (counterpart of ``parallel/``):
``mesh`` (process group and ``DeviceMesh``), ``sharding`` (the Megatron
split by head group), ``train`` (the ASR loss and train step) and
``checkpoint``."""

from light_whisper_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, init_distributed, make_mesh

__all__ = ["DATA_AXIS", "MODEL_AXIS", "init_distributed", "make_mesh"]
