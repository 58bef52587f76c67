from .backends import (BackendBase, MultiprocessingBackend,  # noqa: F401
                       NativeBackend, ShardedBackend, get_client,
                       reset_client, set_client)
from .batches import BatchHandler  # noqa: F401
from .cluster import ClusterBackend  # noqa: F401
from .multihost import MultihostBackend  # noqa: F401
