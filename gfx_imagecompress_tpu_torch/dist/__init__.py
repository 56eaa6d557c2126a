"""Block-sharded encoding over ``torch.distributed``."""
