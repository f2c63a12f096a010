"""Sharding rules and compressed collectives over ``torch.distributed``."""
