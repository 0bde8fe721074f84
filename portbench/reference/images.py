"""What the image classifiers share: uint8 NHWC images in, NCHW float32
batches to the forward, one label a row, mean cross entropy.

A training step's rows are normalized ((x/255 - mean)/std), padded by
``crop_pad`` with the value a black pixel normalizes to, cropped at the
drawn offsets and flipped where drawn, as the reference URSABench's CIFAR
transform does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .models import Model


class ImageClassifier(Model):
    def __init__(self, cfg: dict):
        self.cfg = cfg
        self.image = tuple(int(v) for v in cfg["image"])  # (H, W, channels)
        self.num_classes, self.in_channels = int(cfg["num_classes"]), self.image[2]

    def example(self, batch: int, device="meta"):
        h, w, c = self.image
        return (torch.empty((batch, c, h, w), device=device),
                torch.zeros(batch, dtype=torch.long, device=device))

    def train_batch(self, inputs: torch.Tensor, labels: torch.Tensor, draws: dict, i: int):
        rows = draws["plan"][i]
        crop_pad = int(self.cfg["crop_pad"])
        x = inputs.index_select(0, rows).to(torch.float32) / 255.0
        m = torch.tensor(self.cfg["mean"], dtype=torch.float32, device=x.device)
        s = torch.tensor(self.cfg["std"], dtype=torch.float32, device=x.device)
        x = ((x - m) / s).permute(0, 3, 1, 2)  # NCHW
        b, c, h, w = x.shape
        if crop_pad:
            canvas = (-m / s).view(1, c, 1, 1).expand(b, c, h + 2 * crop_pad,
                                                      w + 2 * crop_pad).clone()
            canvas[:, :, crop_pad:crop_pad + h, crop_pad:crop_pad + w] = x
            r = draws["ox"][i].view(b, 1) + torch.arange(h, device=x.device)
            col = torch.arange(w, device=x.device).expand(b, w)
            if draws["flip"] is not None:
                col = torch.where(draws["flip"][i].view(b, 1), w - 1 - col, col)
            col = draws["oy"][i].view(b, 1) + col
            bi = torch.arange(b, device=x.device).view(b, 1, 1)
            x = canvas.permute(0, 2, 3, 1)[bi, r.view(b, h, 1), col.view(b, 1, w)].permute(
                0, 3, 1, 2)
        elif draws["flip"] is not None:
            x = torch.where(draws["flip"][i].view(b, 1, 1, 1), x.flip(3), x)
        return x.contiguous(), labels.index_select(0, rows)

    def loss(self, logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return F.cross_entropy(logits, target)
