"""The port's SIBR viewer bridge against the JAX package's, over loopback.

Both `NetworkGUI`s answer the same client request (the message of
`tests/test_viewer.py`, at scaling modifier 1.0 and 0.5) on the same
scene: the port renders through its `render()` on the CPU, the JAX bridge
through the "jnp" backend. The verify string comes back as sent, and the
two uint8 images differ by at most 1 at no more than 0.1% of the pixels.
The port's training hook serves the same bytes from a `TrainState`.
"""

import json
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsplat_tpu.core.types import make_render_settings as j_settings
from gsplat_tpu.viewer.network_gui import NetworkGUI as JGUI
from gsplat_tpu_torch.config import ModelConfig, PipelineConfig
from gsplat_tpu_torch.core.types import make_render_settings as t_settings
from gsplat_tpu_torch.viewer.network_gui import NetworkGUI as TGUI
from tests.oracle.reference_math import make_test_scene
from tests.test_forward_vs_oracle import scene_to_inputs
from tests.test_torch_projection import port_inputs
from tests.test_torch_train_loop import one_torch_thread  # noqa: F401 (fixture)
from tests.test_viewer import _client_message

WIDTH, HEIGHT = 64, 48


def serve(gui, pump, message):
    """Send `message` from a loopback client, pump `gui` until it answered;
    returns (image, verify string)."""
    port = gui.listener.getsockname()[1]
    result = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            payload = json.dumps(message).encode("utf-8")
            s.sendall(len(payload).to_bytes(4, "little") + payload)
            want = message["resolution_x"] * message["resolution_y"] * 3
            buf = b""
            while len(buf) < want:
                buf += s.recv(want - len(buf))
            n = int.from_bytes(s.recv(4), "little")
            result["verify"] = s.recv(n).decode("ascii")
            result["image"] = np.frombuffer(buf, np.uint8).reshape(
                message["resolution_y"], message["resolution_x"], 3)

    t = threading.Thread(target=client)
    t.start()
    # a pass that accepts the connection also serves its one request
    deadline = time.monotonic() + 30
    while gui.conn is None and time.monotonic() < deadline:
        pump()
        time.sleep(0.001)
    t.join(timeout=30)
    assert not t.is_alive() and result, "viewer round trip did not complete"
    return result["image"], result["verify"]


@pytest.fixture(scope="module")
def scene():
    sc = make_test_scene(np.random.default_rng(0), n=500, width=WIDTH, height=HEIGHT,
                         sh_degree=1)
    params, camera, alive = scene_to_inputs(sc)
    return params, camera, alive


@pytest.mark.parametrize("scaling_modifier", [1.0, 0.5])
def test_port_viewer_answers_as_the_jax_viewer(scene, scaling_modifier):
    params, camera, alive = scene
    message = {**_client_message(WIDTH, HEIGHT), "scaling_modifier": scaling_modifier}
    images = []
    for gui_cls in (JGUI, TGUI):
        gui = gui_cls(port=0)
        try:
            if gui_cls is JGUI:
                settings = j_settings(sh_degree=1, max_per_tile=1024, instance_capacity=1 << 14,
                                      backend="jnp")

                def pump():
                    gui.pump(params, alive, settings, jnp.zeros(3), "loopback-src", 1, 10)
            else:
                tp, _, ta = port_inputs(params, camera, alive)

                def pump():
                    gui.pump(tp, ta, t_settings(sh_degree=1), [0.0, 0.0, 0.0], "loopback-src",
                             1, 10)
            img, verify = serve(gui, pump, message)
        finally:
            gui.close()
        assert verify == "loopback-src" and img.max() > 0
        images.append(img.astype(np.int16))
    diff = np.abs(images[0] - images[1])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def test_training_hook_serves_the_state(scene):
    from gsplat_tpu_torch.convert import PARAM_FIELDS
    from gsplat_tpu_torch.render import render
    from gsplat_tpu_torch.viewer.network_gui import camera_from_request

    params, camera, alive = scene
    tp, _, ta = port_inputs(params, camera, alive)
    state = SimpleNamespace(params={k: getattr(tp, k).detach() for k in PARAM_FIELDS}, alive=ta)
    gui = TGUI(port=0)
    try:
        hook = gui.make_training_hook(ModelConfig(sh_degree=1, source_path="src"),
                                      PipelineConfig())
        message = _client_message(WIDTH, HEIGHT)
        img, verify = serve(gui, lambda: hook(1, state, None), message)
        cam, _, _, sm = gui_request(message)
    finally:
        gui.close()
    assert verify == "src"
    with torch.no_grad():
        want = render(camera_from_request(cam, "cpu"), tp, ta, t_settings(sh_degree=1,
                      scale_modifier=sm), [0.0, 0.0, 0.0], device="cpu")["render"]
    np.testing.assert_array_equal(img, (np.clip(want.numpy(), 0, 1) * 255).astype(np.uint8))


def gui_request(message):
    """What `NetworkGUI.receive` decodes from `message`."""
    class Conn:
        def __init__(self, data):
            self.data = data

        def recv(self, n):
            out, self.data = self.data[:n], self.data[n:]
            return out

    payload = json.dumps(message).encode("utf-8")
    gui = TGUI.__new__(TGUI)
    gui.conn = Conn(len(payload).to_bytes(4, "little") + payload)
    return gui.receive()
