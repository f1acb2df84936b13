"""Multi-device: a single-process device mesh (``mesh.py``) and the
sharded solvers of airdos_tpu/parallel/sharded_ba.py (``sharded_ba.py``)."""
