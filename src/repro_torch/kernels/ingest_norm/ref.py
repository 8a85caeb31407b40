"""Plain PyTorch version of ``ingest_norm``: uint8 HWC -> normalized float CHW
(the paper's ``transform`` tail: to-tensor + normalize)."""
import torch


def ingest_norm_ref(
    img_u8: torch.Tensor,  # (B, H, W, C) uint8
    mean: torch.Tensor,  # (C,) in [0,1] units
    std: torch.Tensor,  # (C,)
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    x = img_u8.to(torch.float32) / 255.0
    x = (x - mean.to(torch.float32)) / std.to(torch.float32)
    return x.permute(0, 3, 1, 2).to(out_dtype).contiguous()  # (B, C, H, W)
