"""REPRO001 — bit parity: TF32 switched on, or a convolution outside the
cuDNN guard.

The reference's REPRO001 guards an XLA hazard (eager arithmetic that jit
would contract into an FMA).  The port's parity hazard is PyTorch's own
reduced precision on the card: ``torch.backends.cuda.matmul.allow_tf32``
or ``torch.backends.cudnn.allow_tf32`` set to anything but ``False``, or
``torch.set_float32_matmul_precision`` with anything but ``"highest"``,
runs float32 products in TF32 (10-bit mantissas) and the card no longer
agrees with the plain version.  cuDNN also defaults its float32
convolutions to TF32 and picks algorithms nondeterministically, so every
convolution must run under ``torch.backends.cudnn.flags(...,
allow_tf32=False)`` (``models/resnet.py``'s ``_cudnn_guard``, inside its
``_Conv2d``; ROADMAP.md, departure 11): a convolution call outside a
``with`` of that guard is flagged.
"""

from __future__ import annotations

import ast

from ..core import FileContext, Rule, register
from ..scopes import dotted_parts, final_name

CONV_FUNCS = {"conv1d", "conv2d", "conv3d", "conv_nd", "conv_transpose1d",
              "conv_transpose2d", "conv_transpose3d", "convolution",
              "convolution_backward"}
GUARDS = {"_cudnn_guard"}


def _is_false(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def _guarded(ctx: FileContext, node: ast.AST) -> bool:
    """True inside a ``with _cudnn_guard(...)`` or a ``with
    cudnn.flags(..., allow_tf32=False)``."""
    for anc in ctx.ancestors(node):
        if not isinstance(anc, (ast.With, ast.AsyncWith)):
            continue
        for item in anc.items:
            call = item.context_expr
            if not isinstance(call, ast.Call):
                continue
            name = final_name(call.func)
            if name in GUARDS:
                return True
            if name == "flags" and "cudnn" in dotted_parts(call.func) and \
                    any(kw.arg == "allow_tf32" and _is_false(kw.value)
                        for kw in call.keywords):
                return True
    return False


@register
class TF32AndConvGuard(Rule):
    id = "REPRO001"
    name = "tf32-or-unguarded-convolution"

    def check_file(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                self._check_assign(ctx, node)
            elif isinstance(node, ast.Call):
                self._check_call(ctx, node)

    def _check_assign(self, ctx: FileContext, node):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for tgt in targets:
            if isinstance(tgt, ast.Attribute) and tgt.attr == "allow_tf32" \
                    and not _is_false(node.value):
                ctx.add(node, self.id,
                        f"`{'.'.join(dotted_parts(tgt))}` switched on: "
                        "float32 products run in TF32 and the card no "
                        "longer agrees with the plain version — leave it "
                        "False")

    def _check_call(self, ctx: FileContext, node: ast.Call):
        name = final_name(node.func)
        if name == "set_float32_matmul_precision":
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                ctx.add(node, self.id,
                        "`set_float32_matmul_precision` below \"highest\" "
                        "runs float32 products in TF32 or bf16 — the card "
                        "no longer agrees with the plain version")
        elif name in CONV_FUNCS and not _guarded(ctx, node):
            ctx.add(node, self.id,
                    f"convolution `{'.'.join(dotted_parts(node.func))}` "
                    "outside the cuDNN guard: cuDNN defaults float32 "
                    "convolutions to TF32 and a nondeterministic algorithm "
                    "— run it under models/resnet.py's _cudnn_guard")
