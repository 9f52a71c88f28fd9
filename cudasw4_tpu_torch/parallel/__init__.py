"""The database sharded over several devices (``sharding``), and meshes
that span processes over ``torch.distributed`` (``multihost``)."""
