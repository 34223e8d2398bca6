"""Adapters that build the port's system under test for a configuration.

A configuration's file names its adapter under ``"app"``; the harness
imports ``bench.apps.<app>`` and calls ``build(config, grid, device)``.
An adapter makes the cell's inputs from a seed and hands the same inputs
to the port and to the configuration's plain reference.
"""
