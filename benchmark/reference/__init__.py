"""The benchmark's plain PyTorch reference of one LoRA erase train step:
the UNet (`unet`), the DDIM partial denoise, the ESD loss and AdamW
(`train`). It imports nothing of the measured program."""
