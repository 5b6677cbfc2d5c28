"""Multi-device support of the port on ``torch.distributed``: the logical-
axis rules (``sharding``) and the collectives (``collectives``)."""
