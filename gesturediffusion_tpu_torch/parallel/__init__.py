"""Multi-rank runs over torch.distributed: the process group
(``distributed``) and the (data, model) grid of ranks with its tensor-
parallel rule (``mesh``).  Counterpart of gesturediffusion_tpu/parallel/."""
