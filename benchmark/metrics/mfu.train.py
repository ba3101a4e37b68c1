"""The training step's share of the card's bf16 peak (%): the model
operations of the steps completed in the traced run's window outside its
traced slice (``yardstick.Step.train_flops``, counted from the recipe's
sizes), over those seconds times 989 TFLOP/s. The slice is left out
because the tracer slows a host-paced step. The run's
``device.power_limit_w`` gives the card's power limit beside it."""

from benchmark import yardstick


def read(rec):
    steps, seconds = rec.get("untraced", (0, 0))
    if not steps or seconds <= 0:
        return None
    flops = rec["step"].train_flops() * steps
    return 100.0 * flops / (seconds * yardstick.BF16_OPS_PER_S)
