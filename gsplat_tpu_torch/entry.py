"""Entry point: the forward render of the seeded tiny scene on one card.

Counterpart of `__graft_entry__.py:entry`: `entry()` returns `(fn, args)`,
where `fn(*args)` renders `synthetic.tiny_scene()` (4,096 gaussians, SH 3,
256x192) with float32 packets and the sorted blend and returns the (H, W,
3) image. On the card it runs K1' (expand and pack) and K2'. Unlike the JAX
entry it never falls back on its own: with no device given it runs on
`cuda` and raises without a card; `entry("cpu")` runs the plain twins.
"""

from __future__ import annotations

from gsplat_tpu_torch.core.types import make_render_settings
from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.render import render
from gsplat_tpu_torch.synthetic import tiny_scene


def entry(device=None):
    """(fn, example_args): the forward render of the tiny scene."""
    dev = resolve_device(device)
    params, alive, camera = tiny_scene(device=dev)
    settings = make_render_settings(sh_degree=3)

    def forward(params, alive):
        return render(camera, params, alive, settings, [0.0, 0.0, 0.0], device=dev)["render"]

    return forward, (params, alive)
