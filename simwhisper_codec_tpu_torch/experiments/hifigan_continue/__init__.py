"""The continuous-feature HiFi-GAN recipe: data prep, feature extraction, training."""
