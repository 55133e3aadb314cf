"""rcgan_tpu — a JAX/XLA framework for training conditional GANs robust to
noisy labels.

A ground-up rebuild of the capabilities of tkkiran/Robust-Conditional-GAN
("Robustness of conditional GANs to noisy labels", NeurIPS 2018,
arXiv 1811.03205): six training modes (biased, unbiased, ambient, RCGAN,
RCGAN-U with a learned confusion matrix + permutation regularizer, RCGAN+y),
two model zoos (MNIST conditional DCGAN; CIFAR-10 SNGAN with projection
discriminator on a ResNet backbone), data pipelines with noisy-label
corruption, and the evaluation suite (generator label accuracy, inception
score, label recovery, MS-SSIM) — written SPMD-first for device meshes.
"""

__version__ = "0.1.0"
