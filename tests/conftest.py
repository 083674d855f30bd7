def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-device subprocess tests (forced host device counts)")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written kernels); skips without one")
