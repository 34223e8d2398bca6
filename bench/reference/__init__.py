"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the port: each is written from the published
equations, takes its inputs from the harness and works out everything
else itself (docs of each module).
"""
