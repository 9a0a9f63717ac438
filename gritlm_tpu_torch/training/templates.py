"""GritLM chat/embed template constants and prompt helpers.

Format contract of the reference (gritlm/training/run.py:17-29 and
README.md:297-303). The exact strings matter: off-by-one on the
`<|embed|>` boundary changes what gets pooled (SURVEY §7 hard parts).
A copy of `gritlm_tpu.training.templates` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

BASE_BOS = "<s>"
TURN_SEP = "\n"
USER_BOS = "<|user|>\n"
USER_EOS = ""  # "</s>" for Zephyr format
EMBED_BOS = "\n<|embed|>\n"
EMBED_EOS = ""
ASSISTANT_BOS = "\n<|assistant|>\n"
ASSISTANT_EOS = "</s>"


def embed_prefix(instruction: str) -> str:
    """Prompt prefix before the text-to-embed. Instruction is stripped of
    '\\t\\n :' (MEDI leftovers; reference data.py:184-197)."""
    instruction = instruction.strip("\t\n :") if instruction else ""
    if instruction:
        return BASE_BOS + USER_BOS + instruction + USER_EOS + EMBED_BOS
    return BASE_BOS + EMBED_BOS.lstrip()


def format_embed(sample) -> Tuple[str, str]:
    """sample: str or (instruction, text). Returns (full_prompt, prefix) —
    prefix token length is masked out of pooling."""
    if isinstance(sample, str):
        return BASE_BOS + EMBED_BOS.lstrip() + sample + EMBED_EOS, BASE_BOS + EMBED_BOS.lstrip()
    instruction, text = sample[0], sample[1]
    prefix = embed_prefix(instruction)
    return prefix + text + EMBED_EOS, prefix


def format_generative(turns: Sequence[str]) -> Tuple[str, List[Tuple[str, bool]]]:
    """turns: [user, assistant, user, assistant, ...]. Returns the full
    prompt and per-segment (string, is_loss) pairs for label masking:
    user segments (+ template glue) carry no loss, assistant ones do
    (reference data.py:208-228, 270-279)."""
    if isinstance(turns, str):
        turns = [turns]
    segments: List[Tuple[str, bool]] = []
    for i in range(0, len(turns), 2):
        user = turns[i]
        assistant = turns[i + 1].strip() if i + 1 < len(turns) else ""
        lead = BASE_BOS if i == 0 else TURN_SEP
        segments.append((lead + USER_BOS + user + USER_EOS + ASSISTANT_BOS, False))
        segments.append((assistant + ASSISTANT_EOS, True))
    full = "".join(s for s, _ in segments)
    return full, segments


def gritlm_instruction(instruction: str = "") -> str:
    """Inference-side instruction format (reference README quickstart +
    rag/eval.py:38-39)."""
    return (
        "<|user|>\n" + instruction + "\n<|embed|>\n" if instruction else "<|embed|>\n"
    )
