"""Semantic segmentation training/prediction (the reference's segmenter app).

Counterpart of examples/segmenter.c (train_segmenter / predict_segmenter):
a NetworkDef whose last layer outputs per-pixel class maps (typically conv +
upsample stack ending in ``classes`` channels with [logistic] or softmax),
trained with per-pixel cross-entropy against mask images.  Masks follow the
darknet convention: image path -> mask path by find_replace ("images" ->
"mask"), one integer class id per pixel (PNG, value = class index).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import optax

from yoloq.data.image import load_image_rgb, resize_bilinear_darknet
from yoloq.data.voc import read_image_list
from yoloq.nn.graph import NetworkDef, init_params
from yoloq.train.classify import _forward_all
from yoloq.nn.graph import ForwardMode


def mask_path_for(image_path: str) -> str:
    return image_path.replace("images", "mask").rsplit(".", 1)[0] + ".png"


class SegmentationDataset:
    def __init__(self, list_file: str, net_w: int, net_h: int, classes: int):
        self.paths = read_image_list(list_file)
        self.net_w, self.net_h = net_w, net_h
        self.classes = classes

    def __len__(self):
        return len(self.paths)

    def sample(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        p = self.paths[idx % len(self.paths)]
        im = resize_bilinear_darknet(load_image_rgb(p), self.net_w, self.net_h)
        with Image.open(mask_path_for(p)) as m:
            mask = np.asarray(
                m.convert("L").resize((self.net_w, self.net_h), Image.NEAREST),
                dtype=np.int32,
            )
        return im, np.clip(mask, 0, self.classes - 1)


class SegmenterTrainer:
    """Per-pixel softmax-CE on the net's final feature map (upsampled to the
    input resolution when the net downsamples)."""

    def __init__(self, net: NetworkDef, classes: int, lr: float = 1e-3,
                 momentum: float = 0.9, key=None):
        self.net = net
        self.classes = classes
        self.params = init_params(key or jax.random.PRNGKey(0), net)
        self.tx = optax.sgd(lr, momentum=momentum)
        self.opt_state = self.tx.init(self.params)

        @jax.jit
        def step(params, opt_state, images, masks):
            def loss_fn(p):
                outs, bn_stats = _forward_all(net, p, images, ForwardMode(train=True))
                logits = outs[-1]  # (N, h, w, classes)
                fh, fw = logits.shape[1:3]
                # downsample the mask to the feature resolution (nearest)
                ys = (jnp.arange(fh) * masks.shape[1] // fh)
                xs = (jnp.arange(fw) * masks.shape[2] // fw)
                m = masks[:, ys][:, :, xs]
                ce = optax.softmax_cross_entropy_with_integer_labels(logits, m)
                return jnp.mean(ce), bn_stats

            (loss, bn_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = self.tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            # darknet .99/.01 rolling stats so inference-mode predict works
            for i, (mean, var) in bn_stats.items():
                params[i]["mean"] = 0.99 * params[i]["mean"] + 0.01 * mean
                params[i]["var"] = 0.99 * params[i]["var"] + 0.01 * var
            return params, opt_state, {"loss": loss}

        self._step = step

    def step(self, images: np.ndarray, masks: np.ndarray):
        self.params, self.opt_state, metrics = self._step(
            self.params, self.opt_state, jnp.asarray(images), jnp.asarray(masks)
        )
        return metrics

    def predict(self, image: np.ndarray) -> np.ndarray:
        """Per-pixel argmax class map at the feature resolution, upsampled
        back to the input size (predict_segmenter analog)."""
        outs, _ = _forward_all(
            self.net, self.params, jnp.asarray(image[None]), ForwardMode()
        )
        logits = np.asarray(outs[-1])[0]
        pred = np.argmax(logits, -1).astype(np.uint8)
        from PIL import Image

        return np.asarray(
            Image.fromarray(pred).resize(
                (image.shape[1], image.shape[0]), Image.NEAREST
            )
        )
