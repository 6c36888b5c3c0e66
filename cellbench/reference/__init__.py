"""The plain reference that decides ``correct``.

Plain PyTorch and NumPy in float32 with TF32 off.  It imports nothing of
``arcle_tpu_torch`` (and neither ``jax`` nor ``arcle_tpu``) and takes
nothing that the port made: the benchmark hands it the seed's inputs and
weights, and it works out the rest again.  Where it follows the port's own
random draws (the reset pool, the auto-reset rows of the answer-given
env, the minibatch shuffles), it checks that stage by itself.
"""
