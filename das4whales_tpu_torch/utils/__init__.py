"""Device resolution and the kernel build."""
