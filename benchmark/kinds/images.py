"""Traffic kind ``images``: ``image_size`` × ``image_size`` × ``channels``
standard-normal pixels in bf16 (NHWC) and labels drawn uniformly from
``num_classes``."""

import torch


def make_batch(traffic: dict, data: dict, gen: torch.Generator,
               device) -> dict[str, torch.Tensor]:
    rows = int(traffic["rows_per_chip"])
    size, ch = int(traffic["image_size"]), int(traffic["channels"])
    images = torch.randn((rows, size, size, ch), generator=gen,
                         device=device, dtype=torch.float32)
    labels = torch.randint(0, int(traffic["num_classes"]), (rows,),
                           generator=gen, device=device, dtype=torch.int64)
    return {"image": images.to(torch.bfloat16),
            "label": labels.to(torch.int32)}


def real_tokens(batch: dict) -> int:
    return 0


def overrides(traffic: dict) -> list[str]:
    return [f"data.image_size={traffic['image_size']}",
            f"data.channels={traffic['channels']}",
            f"data.num_classes={traffic['num_classes']}"]
