"""Pytest settings shared by the test files: registers the ``cuda`` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU with nvcc (the port's CUDA kernels); "
        "skips where torch.cuda.is_available() is false",
    )
