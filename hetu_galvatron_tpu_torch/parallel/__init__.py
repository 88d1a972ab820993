"""SPMD plans over ranks: the collectives (``comm``), the per-rank train
step under a layer-wise hybrid plan (``spmd``) and the rank-spawning
helper (``launch``)."""
