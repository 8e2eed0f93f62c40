"""Tensor-parallel serving: the sharding rules (``rules``) and the rank
group that runs a model's head slices in torch.distributed processes
(``group``)."""
