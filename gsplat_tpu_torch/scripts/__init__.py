"""Counterparts of the JAX package's scripts under the repository's
`scripts/`, one module per script, run as `python -m
gsplat_tpu_torch.scripts.<name>`:

- `make_fixtures`: the fixture scenes of `scripts/make_fixtures.py` (the
  one- and two-gaussian snapshots, the disc-splat COLMAP scene and the
  gaussian-GT COLMAP scene of the quality run), its ground truth rendered
  through the port;
- `colmap_proxy`: the COLMAP quality run of `scripts/colmap_proxy_r5.sh`
  and its collector (the COLMAP part of `scripts/collect_r5.py`).
"""
