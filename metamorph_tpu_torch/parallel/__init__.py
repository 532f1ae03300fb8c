"""Multi-GPU training: the device mesh, its process groups, the sharding plan and ring attention."""
