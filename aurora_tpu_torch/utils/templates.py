"""Prompt templates (a copy of aurora_tpu/utils/templates.py, which the
port may not import).

Behavioral parity with the reference template table
(src/xtuner/xtuner/utils/templates.py:87, `PROMPT_TEMPLATE.vicuna` et al.).
Only templates exercised by AuroraCap's pipelines are included; the table is
an ordinary dict so downstream code can register more.

Each template provides:
  SYSTEM:      format string with ``{system}`` — prepended once per dialog.
  INSTRUCTION: format string with ``{input}`` (and optionally ``{round}``).
  SEP:         separator inserted between rounds.
  STOP_WORDS:  optional list of generation stop strings.
"""

from types import SimpleNamespace

PROMPT_TEMPLATE = SimpleNamespace(
    default=dict(
        SYSTEM="<|System|>:{system}\n",
        INSTRUCTION="<|User|>:{input}\n<|Bot|>:",
        SEP="\n",
    ),
    vicuna=dict(
        SYSTEM=(
            "A chat between a curious user and an artificial "
            "intelligence assistant. The assistant gives "
            "helpful, detailed, and polite answers to the "
            "user's questions. {system}\n "
        ),
        INSTRUCTION="USER: {input} ASSISTANT:",
        SEP="\n",
    ),
    llama3_chat=dict(
        SYSTEM=(
            "<|start_header_id|>system<|end_header_id|>\n\n{system}<|eot_id|>"
        ),
        INSTRUCTION=(
            "<|start_header_id|>user<|end_header_id|>\n\n{input}<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n"
        ),
        SEP="",
        STOP_WORDS=["<|eot_id|>"],
    ),
    internlm2_chat=dict(
        SYSTEM="<|im_start|>system\n{system}<|im_end|>\n",
        INSTRUCTION=(
            "<|im_start|>user\n{input}<|im_end|>\n<|im_start|>assistant\n"
        ),
        SEP="\n",
        STOP_WORDS=["<|im_end|>"],
    ),
    qwen_chat=dict(
        SYSTEM="<|im_start|>system\n{system}<|im_end|>\n",
        INSTRUCTION=(
            "<|im_start|>user\n{input}<|im_end|>\n<|im_start|>assistant\n"
        ),
        SEP="\n",
        STOP_WORDS=["<|im_end|>", "<|endoftext|>"],
    ),
)


def render_conversation(template: dict, messages, system: str = "") -> str:
    """Render a MULTI-ROUND OpenAI-style message list the way the
    reference chat tools accumulate prompts (xtuner tools/chat.py:
    SYSTEM + INSTRUCTION(round=1) + reply + SEP + INSTRUCTION(round=2)
    + ...): each user turn opens a round, each assistant turn closes it.
    `messages`: [{"role": "system"|"user"|"assistant", "content": str}].
    The rendered prompt ends mid-round, awaiting the assistant."""
    sys_parts = [m["content"] for m in messages if m["role"] == "system"]
    if system:
        sys_parts.insert(0, system)
    text = ""
    if sys_parts and "SYSTEM" in template:
        text += template["SYSTEM"].format(system=" ".join(sys_parts))
    round_no = 1
    pending: list = []  # consecutive user turns merge into ONE round —
    # rendering each separately would emit a dangling empty assistant
    # marker mid-context (INSTRUCTION templates end with it)
    for m in messages:
        if m["role"] == "user":
            pending.append(m["content"])
        elif m["role"] == "assistant":
            text += template["INSTRUCTION"].format(
                input="\n".join(pending), round=round_no)
            pending = []
            text += m["content"] + template["SEP"]
            round_no += 1
    # dialog must end awaiting the assistant
    text += template["INSTRUCTION"].format(input="\n".join(pending),
                                           round=round_no)
    return text


def apply_template(template: dict, user_input: str, system: str = "",
                   round: int = 1, with_system: bool = None) -> str:
    """Render a single-round prompt the way the reference CLI does
    (inference.py:85 uses INSTRUCTION only; SYSTEM is prepended when a
    system message is provided)."""
    instruction = template["INSTRUCTION"]
    text = instruction.format(input=user_input, round=round)
    use_system = with_system if with_system is not None else bool(system)
    if use_system and "SYSTEM" in template:
        text = template["SYSTEM"].format(system=system) + text
    return text
