"""Multi-process execution on ``torch.distributed``: image rows sharded over
ranks, the scene replicated, explicit collectives (``mesh.py``); process
groups across hosts or spawned on this one (``multihost.py``); the dry run
(``dryrun.py``) and the scaling report (``scaling.py``)."""
