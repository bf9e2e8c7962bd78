from . import mesh, multihost
from .mesh import Group, Shard, active, current, group
from .multihost import is_primary, launch, maybe_initialize
