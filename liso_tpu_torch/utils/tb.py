"""TensorBoard logging factory (a copy of liso_tpu/utils/tb.py).

Behavioral reference: liso/slim/utils/tb_factory.py:48-71 (cached named
SummaryWriters with a default global step). Uses torch's
SummaryWriter; degrades to a no-op writer when tensorboard is
unavailable.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict


class _NoopWriter:
    def __getattr__(self, name):
        return lambda *a, **k: None


class TBFactory:
    def __init__(self, base_dir):
        self.base_dir = Path(base_dir)
        self._writers: Dict[str, object] = {}
        self.global_step = 0

    def __call__(self, run: str, prefix: str = ""):
        key = run
        if key not in self._writers:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writers[key] = SummaryWriter(
                    log_dir=str(self.base_dir / run)
                )
            except Exception:
                self._writers[key] = _NoopWriter()
        return _PrefixedWriter(self._writers[key], prefix, self)


class _PrefixedWriter:
    def __init__(self, writer, prefix: str, factory: TBFactory):
        self._w = writer
        self._prefix = prefix
        self._factory = factory

    def add_scalar(self, tag, value, global_step=None):
        step = self._factory.global_step if global_step is None else global_step
        self._w.add_scalar(self._prefix + tag, float(value), step)

    def add_scalars(self, metrics: Dict[str, float], global_step=None):
        for k, v in metrics.items():
            self.add_scalar(k, v, global_step)

    def add_text(self, tag, text, global_step=None):
        step = self._factory.global_step if global_step is None else global_step
        self._w.add_text(self._prefix + tag, text, step)

    def add_image(self, tag, img, global_step=None, dataformats="HWC"):
        step = self._factory.global_step if global_step is None else global_step
        self._w.add_image(self._prefix + tag, img, step, dataformats=dataformats)

    def add_gif(self, tag, frames, global_step=None, fps: int = 5):
        """Animated-GIF image summary via a raw Summary.Image proto with
        GIF-encoded bytes (reference tracker/tracking.py:417-473 — TB
        renders animated GIFs in the images tab). frames: list of
        [H, W, 3] floats in [0, 1]. Degrades to the last frame as a
        static image if the proto path is unavailable."""
        step = self._factory.global_step if global_step is None else global_step
        if not frames:
            return
        try:
            import io

            import numpy as np
            from PIL import Image
            from tensorboard.compat.proto.summary_pb2 import Summary

            imgs = [
                Image.fromarray(
                    (np.clip(f, 0, 1) * 255).astype(np.uint8)
                )
                for f in frames
            ]
            buf = io.BytesIO()
            imgs[0].save(
                buf, format="GIF", save_all=True, append_images=imgs[1:],
                duration=int(1000 / fps), loop=0,
            )
            image = Summary.Image(
                height=imgs[0].height,
                width=imgs[0].width,
                colorspace=3,
                encoded_image_string=buf.getvalue(),
            )
            summary = Summary(
                value=[Summary.Value(tag=self._prefix + tag, image=image)]
            )
            self._w._get_file_writer().add_summary(summary, step)
        except Exception:
            self.add_image(tag, frames[-1], step)

    def add_pr_curve_bank(self, tag, curve, global_step=None,
                          with_figure: bool = False):
        """Log one od_metrics.curves() entry: a raw PR-curve summary for
        the TB PR-Curves tab (reconstructing TP/FP/FN counts from the
        interpolated precision/recall and the GT count), and optionally a
        rendered 3-panel figure — PR, precision&recall vs confidence, and
        TP/FP counts vs confidence (the reference's curve banks,
        od_metrics.py:547-1396)."""
        import numpy as np

        step = self._factory.global_step if global_step is None else global_step
        rec = np.asarray(curve["recall"], np.float64)
        prec = np.asarray(curve["precision"], np.float64)
        conf = np.asarray(curve["confidence"], np.float64)
        ok = np.isfinite(prec) & np.isfinite(rec)
        if not ok.any():
            return
        rec, prec = rec[ok], prec[ok]
        conf = np.where(np.isfinite(conf[ok]), conf[ok], 0.0)
        n_gt = max(int(curve.get("n_gt", 0)), 1)
        tp = rec * n_gt
        fn = n_gt - tp
        fp = np.where(prec > 1e-9, tp * (1.0 / np.maximum(prec, 1e-9) - 1.0), 0.0)
        tn = np.zeros_like(tp)
        # TB pr_curve plugin expects arrays ordered from the LOWEST
        # threshold (high recall) to the highest; our recall axis ascends,
        # i.e. confidence descends — reverse it
        order = slice(None, None, -1)
        try:
            self._w.add_pr_curve_raw(
                self._prefix + tag,
                true_positive_counts=tp[order],
                false_positive_counts=fp[order],
                true_negative_counts=tn[order],
                false_negative_counts=fn[order],
                precision=prec[order],
                recall=rec[order],
                global_step=step,
                num_thresholds=len(rec),
            )
        except Exception:
            pass
        if with_figure:
            try:
                img = render_curve_figure(rec, prec, conf, tp, fp)
                self.add_image(tag + "/curves", img, step)
            except Exception:
                pass

    def flush(self):
        getattr(self._w, "flush", lambda: None)()


def render_curve_figure(rec, prec, conf, tp, fp):
    """3-panel matplotlib figure -> [H, W, 3] float image in [0, 1]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    fig, axes = plt.subplots(1, 3, figsize=(10.5, 3.2), dpi=96)
    axes[0].plot(rec, prec)
    axes[0].set_xlabel("recall")
    axes[0].set_ylabel("precision")
    axes[0].set_title("PR")
    axes[0].set_xlim(0, 1)
    axes[0].set_ylim(0, 1.02)
    axes[1].plot(conf, rec, label="recall")
    axes[1].plot(conf, prec, label="precision")
    axes[1].set_xlabel("confidence")
    axes[1].set_title("P/R vs confidence")
    axes[1].legend(fontsize=7)
    axes[2].plot(conf, tp, label="TP")
    axes[2].plot(conf, fp, label="FP")
    axes[2].set_xlabel("confidence")
    axes[2].set_title("TP/FP counts")
    axes[2].legend(fontsize=7)
    for ax in axes:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].astype(np.float32)
    plt.close(fig)
    return img / 255.0
