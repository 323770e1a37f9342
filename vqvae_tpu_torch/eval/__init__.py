from .metrics import (codebook_stats, psnr, psnr_np, ssim_simple,
                      ssim_simple_np)

__all__ = ["codebook_stats", "psnr", "psnr_np", "ssim_simple",
           "ssim_simple_np"]
