"""`one_thread`: an autouse module fixture that runs torch on one
intra-op thread. The suite runs six workers on the machine's cores,
where a tiny model's many small operations gain nothing from more
threads and wait on the other workers' spinning ones (a test took 10-40x
its time alone). A slow port test file takes it with
`from torch_one_thread import one_thread  # noqa: F401`."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
