"""Training: the codec reconstruction step, the HiFi-GAN losses and step, the codec GAN step."""
