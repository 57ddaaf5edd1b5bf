import torch

# the tests run several to a machine: one thread each keeps them from
# crowding each other out
torch.set_num_threads(1)
