"""The paper's experiments (port of ``robustbnns_tpu/experiments``).

Each module pairs a builder (results → rows → a CSV in the JAX package's
file, columns and order, written with the standard ``csv`` module) with a
figure function (rows → the JAX package's PNG). The builders need torch and
numpy only; matplotlib, seaborn and pandas are imported inside the figure
functions alone, so the experiments compute on a machine that lacks them.
"""
