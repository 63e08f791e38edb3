"""Minimal LLM client (port of ``sesameai_tts_tpu/llm/client.py``): the
surface of the reference's external ``ask_llm`` package over any
OpenAI-compatible HTTP endpoint, with the standard library only.

* ``global_config``: the port's own mutable ``LLMConfig`` singleton
  (SYSTEM_MESSAGE, TEMPERATURE, VERBOSE, MODEL_OPTIONS, API_BASE/API_KEY,
  MAX_TOKENS, TIMEOUT);
* ``ModelManager.resolve_model_alias``: exact, then case-insensitive
  substring match;
* ``AskLLM(resolved_model_alias, config)`` with ``query(q,
  plaintext_output=True, stream=False)`` and a ``history_manager`` with
  ``clear_history()``.  A streamed query yields the text deltas of the
  ``data:`` lines up to ``[DONE]`` and records the turn in the history
  when the stream ends or is closed.
"""

from __future__ import annotations

import json
import urllib.request
from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class LLMConfig:
    SYSTEM_MESSAGE: str = "You are a helpful assistant."
    TEMPERATURE: float = 0.7
    VERBOSE: bool = False
    MODEL_OPTIONS: List[str] = field(default_factory=lambda: ["local-default"])
    API_BASE: str = "http://localhost:8000/v1"
    API_KEY: str = "not-needed"
    MAX_TOKENS: int = 1024
    TIMEOUT: float = 120.0


global_config = LLMConfig()


class ModelManager:
    def __init__(self, config: LLMConfig = global_config):
        self.config = config

    def resolve_model_alias(self, requested: str) -> Optional[str]:
        """Exact, then case-insensitive substring matching."""
        options = self.config.MODEL_OPTIONS
        if requested in options:
            return requested
        lowered = requested.lower()
        matches = [m for m in options if lowered in m.lower()]
        return matches[0] if matches else None


class HistoryManager:
    def __init__(self):
        self.messages: List[dict] = []

    def add(self, role: str, content: str) -> None:
        self.messages.append({"role": role, "content": content})

    def clear_history(self) -> None:
        self.messages = []


class AskLLM:
    def __init__(self, resolved_model_alias: str, config: LLMConfig = global_config):
        self.model = resolved_model_alias
        self.config = config
        self.history_manager = HistoryManager()

    def _request(self, payload: dict):
        req = urllib.request.Request(
            f"{self.config.API_BASE}/chat/completions",
            data=json.dumps(payload).encode(),
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {self.config.API_KEY}",
            },
        )
        return urllib.request.urlopen(req, timeout=self.config.TIMEOUT)

    def _messages(self, q: str) -> List[dict]:
        msgs = [{"role": "system", "content": self.config.SYSTEM_MESSAGE}]
        msgs += self.history_manager.messages
        msgs.append({"role": "user", "content": q})
        return msgs

    def query(self, q: str, plaintext_output: bool = True, stream: bool = False):
        """The response text, or with ``stream=True`` an iterator of its text
        deltas."""
        payload = {
            "model": self.model,
            "messages": self._messages(q),
            "temperature": self.config.TEMPERATURE,
            "max_tokens": self.config.MAX_TOKENS,
            "stream": stream,
        }
        if stream:
            return self._stream_query(q, payload)
        with self._request(payload) as resp:
            data = json.loads(resp.read().decode())
        text = data["choices"][0]["message"]["content"]
        self.history_manager.add("user", q)
        self.history_manager.add("assistant", text)
        return text

    def _stream_query(self, q: str, payload: dict) -> Iterator[str]:
        resp = self._request(payload)
        acc = []
        try:
            for raw in resp:
                line = raw.decode().strip()
                if not line.startswith("data:"):
                    continue
                body = line[5:].strip()
                if body == "[DONE]":
                    break
                delta = json.loads(body)["choices"][0].get("delta", {}).get("content")
                if delta:
                    acc.append(delta)
                    yield delta
        finally:
            resp.close()
            self.history_manager.add("user", q)
            self.history_manager.add("assistant", "".join(acc))
