"""Images made from seeds for the served cells: the pool of JPEGs that the
clients post and the set whose fc7 the PCA is fitted on.

An image is a smooth colour field (a gaussian field on a grid of 1/32 of
the image's sides, upsampled bicubically), four rectangles of random
colour and size, and a little pixel noise: blocks and gradients with
edges, whose JPEG at quality 85 and 480 x 640 takes 30-60 KB, as photos
posted to a search service do. The pixels are made on the device in a few
large calls; the JPEGs are encoded by PIL on the host, baseline and 4:2:0,
so that every one takes the program's coefficient route.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

#: rectangles an image, and the pixel noise's standard deviation
RECTS, PIXEL_NOISE = 4, 3.0


def pixels(n, h, w, g):
    """[n, h, w, 3] uint8 RGB images on ``g``'s device, drawn from ``g``."""
    dev = g.device
    low = torch.randn((n, 3, h // 32 + 2, w // 32 + 2), generator=g,
                      device=dev)
    img = F.interpolate(low, size=(h, w), mode="bicubic",
                        align_corners=False) * 45.0 + 120.0
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)
    for _ in range(RECTS):
        corner = torch.rand((n, 4), generator=g, device=dev)
        y0 = (corner[:, 0] * (h - 32)).long().view(n, 1, 1)
        x0 = (corner[:, 1] * (w - 32)).long().view(n, 1, 1)
        y1 = y0 + 16 + (corner[:, 2] * (h // 2)).long().view(n, 1, 1)
        x1 = x0 + 16 + (corner[:, 3] * (w // 2)).long().view(n, 1, 1)
        inside = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))
        colour = (torch.rand((n, 3), generator=g, device=dev) - 0.5) * 200.0
        img = img + inside[:, None].to(img.dtype) * colour[:, :, None, None]
    img = img + torch.randn(img.shape, generator=g, device=dev) * PIXEL_NOISE
    return img.clamp_(0.0, 255.0).round_().to(torch.uint8) \
        .permute(0, 2, 3, 1).contiguous()


def jpeg(a, quality):
    """One [h, w, 3] uint8 array as baseline 4:2:0 JPEG bytes."""
    import io

    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(a).save(b, format="JPEG", quality=int(quality),
                            subsampling=2, progressive=False)
    return b.getvalue()


def jpeg_pool(n, h, w, quality, g, threads=8):
    """``n`` JPEGs of :func:`pixels` images of ``h`` x ``w``, as bytes."""
    host = pixels(n, h, w, g).cpu().numpy()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        return list(pool.map(lambda a: jpeg(np.ascontiguousarray(a),
                                            quality), host))
