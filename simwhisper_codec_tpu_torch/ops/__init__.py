"""Tensor ops of the codec: frontend, quantizer, convs, resamplers, ISTFT, kernels."""
