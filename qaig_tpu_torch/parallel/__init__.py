"""Parallel forms of the port over ``torch.distributed`` (counterpart of
``qaig_tpu/parallel``): the process mesh (``mesh``), Megatron tensor
parallelism, ZeRO-1 and the gradient reduction (``sharding``), the GPipe
pipeline (``pipeline``), and the runtime and collectives (``comm``)."""
