from .blocked_allocator import BlockedAllocator  # noqa: F401
from .manager import DSSequenceDescriptor, DSStateManager  # noqa: F401
from .ragged_wrapper import RaggedBatchWrapper  # noqa: F401
