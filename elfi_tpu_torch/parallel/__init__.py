from .backends import (BackendBase, NativeBackend, get_client,  # noqa: F401
                       reset_client, set_client)
from .batches import BatchHandler  # noqa: F401
