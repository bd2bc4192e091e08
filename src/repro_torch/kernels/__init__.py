"""The hand-written CUDA kernels for Hopper (attention, Mamba-2 scan, mLSTM
scan, SL boundary quantizer), their plain PyTorch versions, and the ops that
dispatch between them by device."""
