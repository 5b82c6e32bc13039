"""The benchmark's plain reference: plain PyTorch in fp32 (TF32 off), no
hand-written kernel, no batching tricks, and nothing imported from the
program. It takes the benchmark's inputs (weights, images, noise, batches)
and works out again whatever the program derives from them.

Parameter names and layouts follow the published model's (as the program
names them too), so one set of seeded weights loads into both sides.
"""
