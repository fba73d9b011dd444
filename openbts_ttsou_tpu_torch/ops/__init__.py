"""DSP ops of the uplink chain; K1 (the polyphase resampler) is a CUDA
kernel, the rest plain PyTorch."""
