"""Pixel sharding over ``torch.distributed``: one process per device
(``mesh.py``), the process group and image gathering
(``distributed.py``), and a spawned dry run (``dryrun.py``)."""
