"""The plain reference: plain PyTorch, no part of spcl_torch, float32 with TF32 off."""
