"""SIBR remote-viewer bridge, wire-compatible with the reference protocol.

Copy of `gsplat_tpu/viewer/network_gui.py` with its render call rewired to
the port's `render()` on the state's device. Same TCP format as
`gaussian_renderer/network_gui.py:24-86`: a non-blocking listener; requests
are 4-byte little-endian length-prefixed JSON carrying the viewer camera
(glm-convention matrices with Y/Z column flips) and training toggles;
responses are raw H*W*3 bytes followed by the length-prefixed source-path
string. A reference SIBR_remoteGaussian_app can therefore attach to a
training run of the port unmodified.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import traceback
from types import SimpleNamespace

import numpy as np
import torch


class NetworkGUI:
    def __init__(self, host="127.0.0.1", port=6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None
        print(f"[viewer] listening on {host}:{port}")

    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\n[viewer] connected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, OSError):
            pass

    def _read(self):
        n = int.from_bytes(self.conn.recv(4), "little")
        return json.loads(self.conn.recv(n).decode("utf-8"))

    def _send(self, image_bytes, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self):
        """Decode one viewer request -> (camera dict | None, toggles)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        # glm row-vector matrices with Y/Z flips -> math-form (transpose)
        vm = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        vm[:, 1] *= -1
        vm[:, 2] *= -1
        vp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        vp[:, 1] *= -1
        cam = dict(
            width=width,
            height=height,
            fovx=msg["fov_x"],
            fovy=msg["fov_y"],
            world_view=vm.T,
            full_proj=vp.T,
        )
        return (
            cam,
            bool(msg["train"]),
            bool(msg["keep_alive"]),
            float(msg["scaling_modifier"]),
        )

    def _render(self, cam, params, alive, settings, bg, scaling_modifier):
        """The request's view through the port's `render()` on the device
        of `alive`, as (H, W, 3) uint8 bytes."""
        from gsplat_tpu_torch.render import render

        with torch.no_grad():
            img = render(
                camera_from_request(cam, alive.device), params, alive,
                dataclasses.replace(settings, scale_modifier=scaling_modifier), bg,
                device=alive.device,
            )["render"]
        return memoryview((np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8))

    def pump(self, params, alive, settings, bg, source_path, iteration, max_iter):
        """One message-loop pass; call once per training iteration
        (`train.py:74-87` equivalent)."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, do_training, keep_alive, scaling_mod = self.receive()
                img_bytes = None
                if cam is not None:
                    img_bytes = self._render(cam, params, alive, settings, bg, scaling_mod)
                self._send(img_bytes, source_path)
                if do_training and (iteration < max_iter or not keep_alive):
                    break
            except Exception:
                traceback.print_exc()
                self.conn = None

    def make_training_hook(self, model_cfg, pipe_cfg):
        """An `on_iteration` hook of the training loop that serves the viewer
        from the current state, at the model's full SH degree."""
        from gsplat_tpu_torch.core.types import make_render_settings

        settings = make_render_settings(
            sh_degree=model_cfg.sh_degree, antialiasing=pipe_cfg.antialiasing)
        bg = [1.0, 1.0, 1.0] if model_cfg.white_background else [0.0, 0.0, 0.0]

        def hook(iteration, state, metrics):
            self.pump(
                SimpleNamespace(**state.params), state.alive, settings, bg,
                model_cfg.source_path, iteration, 10**9,
            )

        return hook

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()


def camera_from_request(cam: dict, device):
    """The port's Camera of a decoded viewer request (`NetworkGUI.receive`)."""
    from gsplat_tpu_torch.convert import camera_from_numpy

    wv = cam["world_view"]
    return camera_from_numpy(
        wv, cam["full_proj"], np.linalg.inv(wv)[:3, 3], np.float32(np.tan(cam["fovx"] * 0.5)),
        np.float32(np.tan(cam["fovy"] * 0.5)), cam["width"], cam["height"], device,
    )
