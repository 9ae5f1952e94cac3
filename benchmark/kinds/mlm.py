"""Traffic kind ``mlm``: rows of ``seq_len`` token ids, each drawn
uniformly from ``[token_low, vocab_size)``; each position after the first
is masked with probability ``mask_prob`` (the id becomes ``mask_token``,
the target the original id; elsewhere the target is -1); every row is
real tokens to its end (``attention_mask`` all ones)."""

import torch


def make_batch(traffic: dict, data: dict, gen: torch.Generator,
               device) -> dict[str, torch.Tensor]:
    rows, seq = int(traffic["rows_per_chip"]), int(traffic["seq_len"])
    low, vocab = int(traffic["token_low"]), int(data["vocab_size"])
    tokens = torch.randint(low, vocab, (rows, seq), generator=gen,
                           device=device, dtype=torch.int64)
    masked = (torch.rand((rows, seq), generator=gen, device=device)
              < float(traffic["mask_prob"]))
    masked[:, 0] = False
    ids = torch.where(masked, int(traffic["mask_token"]), tokens)
    targets = torch.where(masked, tokens, -1)
    return {"input_ids": ids.to(torch.int32),
            "targets": targets.to(torch.int32),
            "attention_mask": torch.ones((rows, seq), dtype=torch.int32,
                                         device=device)}


def real_tokens(batch: dict) -> int:
    """Non-padding tokens (the attention mask's ones)."""
    return int(batch["attention_mask"].sum())


def overrides(traffic: dict) -> list[str]:
    return [f"data.seq_len={traffic['seq_len']}",
            f"data.mask_prob={traffic['mask_prob']}"]
