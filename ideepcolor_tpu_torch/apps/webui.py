"""Embedded browser UI for the HTTP server (GET /).

The JAX package's ``apps/webui.py`` page, copied verbatim: one
self-contained HTML page (no build step, no external assets) that drives the
same HTTP API a programmatic client uses -- click to place color hints
(client-side sRGB -> Lab), drag the result, pick from /suggest
recommendations, toggle the fast tier. The server of either package serves
it unchanged.
"""

PAGE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>ideepcolor-tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:16px;background:#16181d;color:#e6e6e6}
 h1{font-size:18px;margin:0 0 10px}
 .row{display:flex;gap:16px;flex-wrap:wrap}
 canvas,img#out{border:1px solid #444;image-rendering:pixelated;background:#000}
 .panel{display:flex;flex-direction:column;gap:8px}
 label{font-size:13px}
 button,input[type=file]{font-size:13px}
 #palette{display:flex;gap:4px;flex-wrap:wrap;max-width:256px}
 #palette button{width:24px;height:24px;border:1px solid #666;padding:0}
 #hints{font-size:12px;max-width:300px;color:#9ab}
 #status{font-size:12px;color:#8c8}
</style></head><body>
<h1>ideepcolor-tpu — interactive colorization</h1>
<div class="row">
 <div class="panel">
  <label>grayscale input (click to add a hint)</label>
  <canvas id="cv" width="256" height="256"></canvas>
  <input type="file" id="file" accept="image/*">
  <label>hint color <input type="color" id="color" value="#4488ff">
   radius <input type="number" id="radius" value="2" min="0" max="10"
                 style="width:3em"></label>
  <label><input type="checkbox" id="fast"> fast tier (student)</label>
  <label><input type="checkbox" id="suggest" checked>
   suggest palette on click</label>
  <button id="undo">undo hint</button>
  <button id="reset">clear hints</button>
  <div id="palette"></div>
  <div id="hints"></div>
 </div>
 <div class="panel">
  <label>colorized (net-res)</label>
  <img id="out" width="256" height="256">
  <div id="status">load an image to begin</div>
 </div>
</div>
<script>
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
const out=document.getElementById('out'),status=document.getElementById('status');
let imgBlob=null,hints=[],sessionId=null,S=256;
// the hint grid is the SERVER's net resolution (--load_size); the
// canvas pixel grid tracks it, displayed at a fixed 256 CSS pixels
fetch('/healthz').then(r=>r.json()).then(h=>{
 S=h.size;cv.width=cv.height=S;out.width=out.height=S;
 cv.style.width=cv.style.height=out.style.width=out.style.height='256px';
 if(!h.has_fast)document.getElementById('fast').parentElement.style.display='none';
});
function canvasXY(e){
 const rect=cv.getBoundingClientRect();
 return [Math.min(S-1,Math.max(0,Math.round((e.clientX-rect.left)*S/rect.width))),
         Math.min(S-1,Math.max(0,Math.round((e.clientY-rect.top)*S/rect.height)))];
}
function srgb2lin(v){v/=255;return v<=.04045?v/12.92:Math.pow((v+.055)/1.055,2.4)}
function rgb2lab(r,g,b){
 const rl=srgb2lin(r),gl=srgb2lin(g),bl=srgb2lin(b);
 const x=(.412456*rl+.357576*gl+.180437*bl)/.95047,
       y=.212673*rl+.715152*gl+.072175*bl,
       z=(.019334*rl+.119192*gl+.950304*bl)/1.08883;
 const f=t=>t>216/24389?Math.cbrt(t):(24389/27*t+16)/116;
 const fx=f(x),fy=f(y),fz=f(z);
 return [116*fy-16,500*(fx-fy),200*(fy-fz)];
}
function drawHintMarks(){
 for(const h of hints){
  ctx.fillStyle=h.css;ctx.strokeStyle='#fff';
  ctx.fillRect(h.x-3,h.y-3,6,6);ctx.strokeRect(h.x-3,h.y-3,6,6);
 }
 document.getElementById('hints').textContent=
  hints.map(h=>`(${h.y},${h.x}) ab=[${h.ab[0].toFixed(0)},${h.ab[1].toFixed(0)}]`).join('  ');
}
function redraw(){
 if(!window._img)return;
 ctx.drawImage(window._img,0,0,S,S);
 // show the input as grayscale (the model sees only L)
 const d=ctx.getImageData(0,0,S,S);
 for(let i=0;i<d.data.length;i+=4){
  const l=.299*d.data[i]+.587*d.data[i+1]+.114*d.data[i+2];
  d.data[i]=d.data[i+1]=d.data[i+2]=l;
 }
 ctx.putImageData(d,0,0);
 drawHintMarks();
}
async function openSession(){
 // an interactive session: the image uploads once and stays
 // device-resident; each click then ships only the hint list.
 // the session is tier-specific (fast sessions run the student)
 sessionId=null;
 if(!imgBlob)return;
 const fast=document.getElementById('fast').checked;
 try{
  const r=await fetch('/session'+(fast?'?model=fast':''),
    {method:'POST',body:imgBlob});
  if(r.ok)sessionId=(await r.json()).id;
 }catch(_){}
}
document.getElementById('file').onchange=async e=>{
 const f=e.target.files[0];if(!f)return;
 imgBlob=f;hints=[];
 const img=new Image();
 const u=URL.createObjectURL(f);
 img.onload=()=>{window._img=img;redraw();URL.revokeObjectURL(u);};
 img.src=u;
 await openSession();
 colorizeThrottled();
};
function hintPayload(){
 // radius captured per hint at placement (a later change to the input
 // must not retroactively resize earlier hints)
 return JSON.stringify(hints.map(h=>({y:h.y,x:h.x,ab:h.ab,
   radius:h.radius})));
}
async function colorize(){
 if(!imgBlob)return;
 status.textContent='colorizing…';
 const fast=document.getElementById('fast').checked;
 const t0=performance.now();
 let r;
 if(sessionId){               // session fast path (~1.8 KB per click)
  r=await fetch(`/session/click?id=${sessionId}`,
    {method:'POST',body:hintPayload()});
  if(r.status===404){await openSession();
   if(sessionId)return colorize();}
 }
 if(!sessionId){
  r=await fetch('/colorize?fullres=0'+(fast?'&model=fast':''),
    {method:'POST',body:imgBlob,headers:{'X-Hints':hintPayload()}});
 }
 if(!r.ok){status.textContent='error: '+await r.text();return}
 const old=out.src;                 // revoke: drags would leak a blob
 out.src=URL.createObjectURL(await r.blob());   // per rendered frame
 if(old.startsWith('blob:'))URL.revokeObjectURL(old);
 status.textContent=`ok — ${hints.length} hint(s), ${(performance.now()-t0).toFixed(0)} ms`
   +(sessionId?' (session)':'');
}
async function suggestAt(y,x){
 const r=sessionId
  ?await fetch(`/session/suggest?id=${sessionId}&h=${y}&w=${x}&k=9`,
    {method:'POST',body:hintPayload()})
  :await fetch(`/suggest?h=${y}&w=${x}&k=9`,
    {method:'POST',body:imgBlob,headers:{'X-Hints':hintPayload()}});
 if(!r.ok)return;
 const s=await r.json(),pal=document.getElementById('palette');
 pal.innerHTML='';
 for(const c of s.colors){
  const b=document.createElement('button');
  b.style.background=`rgb(${c[0]},${c[1]},${c[2]})`;
  b.onclick=()=>{
   const hx=hints[hints.length-1];
   if(hx){hx.ab=rgb2lab(c[0],c[1],c[2]).slice(1);
          hx.css=`rgb(${c[0]},${c[1]},${c[2]})`;redraw();colorizeThrottled();}
  };
  pal.appendChild(b);
 }
}
let inflight=false,wantMore=false;
async function colorizeThrottled(){
 // one request in flight, newest hint state wins; the finally clause
 // releases the latch even when a fetch rejects (server restart)
 if(inflight){wantMore=true;return}
 inflight=true;
 try{do{wantMore=false;await colorize();}while(wantMore);}
 finally{inflight=false;}
}
function addHintAt(e){
 const [x,y]=canvasXY(e);
 const hex=document.getElementById('color').value;
 const r=parseInt(hex.slice(1,3),16),g=parseInt(hex.slice(3,5),16),
       b=parseInt(hex.slice(5,7),16);
 hints.push({x,y,ab:rgb2lab(r,g,b).slice(1),css:hex,
             radius:+document.getElementById('radius').value});
 redraw();
 return {x,y};
}
let dragging=false;
cv.onmousedown=e=>{
 if(!imgBlob)return;
 dragging=true;
 const p=addHintAt(e);
 colorizeThrottled();
 if(document.getElementById('suggest').checked)suggestAt(p.y,p.x);
};
cv.onmousemove=e=>{
 if(!dragging||!imgBlob)return;
 // dragging moves the LAST hint (the reference GUI's drag semantics)
 const h=hints[hints.length-1];
 if(!h)return;
 [h.x,h.y]=canvasXY(e);
 redraw();colorizeThrottled();
};
window.onmouseup=()=>{dragging=false;};
document.getElementById('undo').onclick=()=>{hints.pop();redraw();colorizeThrottled();};
document.getElementById('reset').onclick=()=>{hints=[];redraw();colorizeThrottled();};
document.getElementById('fast').onchange=async()=>{
 await openSession();colorizeThrottled();};
</script></body></html>
"""
