"""Hand-written Hopper kernels of the port (CUDA C++ and Triton), their
plain PyTorch versions (``ref``) and the device dispatch (``ops``)."""
