"""The codec GAN trainer and its kill-and-resume soak."""
