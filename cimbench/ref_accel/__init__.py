"""The accel kind's plain reference: Granite-4.0-H's train step in float32
``torch`` (:mod:`cimbench.ref_accel.granite`), the matmul FLOPs of a step
counted from the widths and the routing (:mod:`cimbench.ref_accel.flops`)
and the accelerator-mode selection and pricing
(:mod:`cimbench.ref_accel.pricing`).  It imports nothing of the program.
"""
