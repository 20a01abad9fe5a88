from .sharded_moe import (TopKGate, moe_dispatch_combine, top1gating,  # noqa: F401
                          top2gating)
from .layer import MoE  # noqa: F401
