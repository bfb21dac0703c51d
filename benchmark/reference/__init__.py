"""The benchmark's plain reference of the crowd-navigation system.

Frozen copies of the port's env (``crowd_sim``, ``orca``, ``spawn``,
``kinematics``, ``social_force``, ``types``, ``vector``, ``pretext``), GST
(``st_model``, ``predictor``), policy (``policy_net``, ``policy``,
``distributions``), PPO pieces (``ppo``, ``gae``), configuration
(``config``) and weight loading (``params``), taken when the benchmark was
defined, so that a later change to the program cannot move the yardstick.
The policy's attention is the plain einsum (no kernel), every product runs
at the precision ``precision`` puts in force, and nothing here imports the
program or JAX.
"""
