"""The port's distributed layer, over ``torch.distributed``:

sharding     — logical-axis rules, the resolver, DTensor placements
collectives  — the ring collective-matmuls and their blocking baselines
compression  — blockwise int8 with error feedback, the compressed all-reduce
pipeline     — GPipe over a "stage" mesh dim
fault        — failure detection, retries (the fleet's chaos and degrade
               layers use them), elastic re-meshing

Importing it opens no process group; meshes come from ``launch.mesh``.
"""
