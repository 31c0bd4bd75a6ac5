"""Data-parallel training over a ``torch.distributed`` group (counterpart of
``se_tpu/parallel``): ``mesh.py`` the group, ``dp.py`` the steps,
``launch.py`` ranks spawned on this host."""
