"""Faults planted in the timed path, each of which the comparison that
decides `correct` has to catch: `fault(bundle, optimizer, step) -> step`,
as `runners.lora_train.run_on` takes it. Each patches the program for the
rest of the process; `restore()` undoes them."""

from __future__ import annotations

_ORIGINAL = {}


def _patch(name: str, value) -> None:
    """Replace `leco_tpu_torch.train.trainer.<name>` until `restore()`."""
    from leco_tpu_torch.train import trainer

    _ORIGINAL.setdefault(name, getattr(trainer, name))
    setattr(trainer, name, value)


def unchanged_state(bundle, optimizer, step):
    """A step that returns its state unchanged: the optimizer never steps."""
    optimizer.step = lambda *a, **k: None
    return step


def half_batch(bundle, optimizer, step):
    """Half of the batch left out, the loss's mean taken over the rest."""
    from leco_tpu_torch.train import trainer

    esd = _ORIGINAL.get("esd_loss", trainer.esd_loss)

    def loss(pred, positive, uncond, neutral, g, sign):
        h = pred.shape[0] // 2
        return esd(pred[:h], positive[:h], uncond[:h], neutral[:h], g, sign)

    _patch("esd_loss", loss)
    return step


def fold_skipped(bundle, optimizer, step):
    """The inner denoise runs on the base weights: the LoRA is never folded
    into them (as a stale or skipped fold would leave it)."""
    from leco_tpu_torch.train import trainer

    mode = _ORIGINAL.get("lora_mode", trainer.lora_mode)
    _patch("folded_lora", lambda unet: mode(unet, "off"))
    return step


def lora_on_reference(bundle, optimizer, step):
    """The 3B reference forward runs with the LoRA on instead of off."""
    from leco_tpu_torch.train import trainer

    mode = _ORIGINAL.get("lora_mode", trainer.lora_mode)
    _patch("lora_mode", lambda unet, m: mode(unet, "on" if m == "off" else m))
    return step


def restore() -> None:
    if _ORIGINAL:
        from leco_tpu_torch.train import trainer

        for name, value in _ORIGINAL.items():
            setattr(trainer, name, value)
        _ORIGINAL.clear()


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "fold_skipped": fold_skipped, "lora_on_reference": lora_on_reference}
