"""Faults planted under the timed path, each a context manager that
replaces one entry of the program for as long as it is open. The check
must come out not correct under each fault a cell can have (`tests/`),
and `limits.py` reads the numbers under them on the card.

- `unchanged_state`: the train step returns its state unchanged;
- `half_batch`: the loss is taken over the top half of the image, the
  mean over that half (half of the batch left out);
- `altered_frame`: the first tile of every rendered frame is altered
  (an answer altered where it is produced);
- `half_frame`: the bottom half of every rendered frame is left out.

One chip: no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

from splatbench import program

TRAIN = ("unchanged_state", "half_batch")
RENDER = ("altered_frame", "half_frame")


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged_state():
    make = program.make_train_step

    def make_faulty(*args, **kw):
        step = make(*args, **kw)

        def faulty(state, *rest):
            _, metrics = step(state, *rest)
            return state, metrics

        return faulty

    return _patched(program, "make_train_step", make_faulty)


def half_batch():
    from gsplat_tpu_torch.train import losses

    loss = losses.photometric_loss

    def faulty(image, gt, lam):
        h = image.shape[0] // 2
        return loss(image[:h].contiguous(), gt[:h].contiguous(), lam)

    return _patched(losses, "photometric_loss", faulty)


def _frames(alter):
    render = program.render

    def faulty(*args, **kw):
        out = dict(render(*args, **kw))
        out["render"] = alter(out["render"].clone())
        return out

    return _patched(program, "render", faulty)


def altered_frame():
    def alter(img):
        img[:16, :16] = 1.0 - img[:16, :16]
        return img

    return _frames(alter)


def half_frame():
    def alter(img):
        img[img.shape[0] // 2:] = 0.0
        return img

    return _frames(alter)


PLANT = {"unchanged_state": unchanged_state, "half_batch": half_batch,
         "altered_frame": altered_frame, "half_frame": half_frame}
