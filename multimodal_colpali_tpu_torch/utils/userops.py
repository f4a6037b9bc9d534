"""Multi-user app leftovers: password email, per-user data seeding, sync
VLM summarizer with checkpointing (counterpart of
``multimodal_colpali_tpu/utils/userops.py``).

Ports of the reference's L9 utilities: send_password_email
(functions.py:1769-1809), new_user_set_files (functions.py:1866-1868), and
the synchronous per-image summarizer ``api_models_one_img``
(functions.py:526-566, tenacity backoff + periodic pickle checkpoints), its
requests on ``urllib``: the GPU host's Python has no ``httpx``.
"""

from __future__ import annotations

import http.client
import json
import os
import smtplib
import time
import urllib.request
from email.mime.multipart import MIMEMultipart
from email.mime.text import MIMEText
from typing import Any, Dict, List, Optional, Sequence

from multimodal_colpali_tpu_torch.api import save_to_pickle, setup_initial_vector_db
from multimodal_colpali_tpu_torch.generation.messages import encode_image

# what the JAX package retries as httpx.HTTPError (a transport failure or a
# status past 2xx: urllib's URLError and HTTPError are OSErrors), plus a reply
# without choices
_RETRIED = (OSError, http.client.HTTPException, KeyError, IndexError)


def send_password_email(sender_email: str, sender_password: str,
                        recipient_username: str, recipient_email: str,
                        password: str,
                        smtp_server: str = "smtp.gmail.com",
                        smtp_port: int = 587) -> None:
    """Send a password-reset email (SMTP + STARTTLS)."""
    subject = "SynHealth app testing: new password"
    body = (
        f"Dear {recipient_username},\n\n"
        f"Your password has been reset and your login credentials are:\n\n"
        f"username: {recipient_username}\npassword: {password}\n\n"
        f"You can change your password in the user settings.\n"
    )
    msg = MIMEMultipart()
    msg["From"] = sender_email
    msg["To"] = recipient_email
    msg["Subject"] = subject
    msg.attach(MIMEText(body, "plain"))
    with smtplib.SMTP(smtp_server, smtp_port) as server:
        server.starttls()
        server.login(sender_email, sender_password)
        server.send_message(msg)


def new_user_set_files(username: str,
                       input_filename: str = "./src/vectordb/context_base.tar.gz",
                       user_root: str = "./src/vectordb/user_data") -> str:
    """Seed a new user's data directory from the base snapshot
    (reference functions.py:1866-1868)."""
    output_dir = os.path.join(user_root, username)
    setup_initial_vector_db(input_filename, output_dir)
    return output_dir


def _post_json(url: str, headers: Dict[str, str], body: Dict[str, Any], timeout: float):
    req = urllib.request.Request(url, json.dumps(body).encode("utf-8"), headers, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:   # raises HTTPError past 2xx
        return json.loads(r.read())


def api_models_one_img(
    img_links: Sequence[str],
    texts: Sequence[str],
    models_data: Sequence[Dict[str, Any]],
    img_prompt: str,
    text_prompt: str,
    max_tokens: int = 300,
    text_cutoff: int = 1500,
    save_tmp: str = "tmp_save2.pkl",
    retries: int = 10,
    base_backoff: float = 10.0,
    max_backoff: float = 180.0,
) -> List[Dict[str, Any]]:
    """Per-image chat completion with exponential backoff and periodic
    pickle checkpoints (reference functions.py:526-566), over plain HTTP.
    Each model's replies are pickled to ``<model id's last part>[:15].pkl``
    in the working directory (``save_tmp`` is unused, as in the JAX
    package)."""
    gen_text: List[Dict[str, Any]] = []
    for model_data in models_data:
        print(f"Processing for {model_data['model_id']}.")
        url = model_data["api_url"].rstrip("/") + "/chat/completions"
        headers = {"Authorization": f"Bearer {model_data.get('api_key') or 'EMPTY'}",
                   "Content-Type": "application/json"}
        tmp_data = []
        for img_link, text in zip(img_links, texts):
            if img_link == "":
                part = [{"type": "text", "text": text_prompt + text}]
            else:
                part = [
                    {"type": "text", "text": img_prompt},
                    {"type": "image_url", "image_url": {
                        "url": f"data:image/jpeg;base64,{encode_image(img_link)}"}},
                ]
            body = {
                "model": model_data["model_id"],
                "messages": [{"role": "user", "content": part}],
                "max_completion_tokens": max_tokens,
            }
            content: Optional[str] = None
            for attempt in range(retries):
                try:
                    content = _post_json(url, headers, body, 120)["choices"][0]["message"][
                        "content"]
                    break
                except _RETRIED:
                    if attempt == retries - 1:
                        raise
                    time.sleep(min(base_backoff * (2 ** attempt), max_backoff))
            one_resp = {"model": model_data["model_id"], "link": img_link,
                        "output": (content or "")[:text_cutoff]}
            tmp_data.append(one_resp)
            gen_text.append(one_resp)
        tmp_save = model_data["model_id"].split("/")[-1]
        save_to_pickle(tmp_save[:15] + ".pkl", processed_tmp=tmp_data)
    return gen_text
